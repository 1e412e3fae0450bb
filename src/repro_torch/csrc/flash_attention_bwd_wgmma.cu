// Backward of the fused attention on the tensor cores, for Hopper (sm_90a):
// route `bwd_wgmma` of kernels/flash_attention.py, bf16 q, k, v and dO at
// head dim 64, 128 or 256.  Other calls (head dim 16 or 32; float32 at every
// head dim) take route `bwd_fma` (flash_attention_bwd.cu).
//
// No TPU kernel is replaced: the JAX package trains through XLA's
// `chunked_attention` (src/repro/layers/attention.py:95).  The function is
// flash_attention_bwd.cu's (the derivative of the forward's unrounded
// softmax, GQA and the causal / window mask aligned to the end of kv):
//   P = exp(s - lse) on kept keys (s = scale q.k; lse the forward's
//   log-sum-exp, read and never recomputed), dV = P^T dO, dP = dO V^T,
//   D = rowsum(P o dP), dS = P o (dP - D), dQ = scale dS K,
//   dK = scale dS^T Q, the q heads of a group summed into their kv head.
//
// Bound at StarCoder2-3B's training call (q (1, 24, 4096, 128), kv (1, 2,
// 4096, 128), causal): the five products of the function, 258 GFLOP over
// the kept pairs, are 0.26 ms at 989 TFLOP/s; the 29 MB of inputs and
// outputs are 9 us at 3.35 TB/s.  So the tensor cores bound it, and this
// design does nine bf16 products with float32 accumulation (FlashAttention-3,
// Shah et al. 2024, without its dQ atomics, so the result is the same bits
// on every run):
//
// 1. flash_bwd_dq_wgmma — a block (one warpgroup) per (64-row q tile, q
//    head, batch), the last tiles (the most keys under the causal mask)
//    first over all heads and batches, so the light ones fill the last
//    wave.  Q and dO arrive
//    by TMA once; 64-key K and V tiles stream through two slots.  It walks
//    the tile's kept key range twice: pass 1 runs S = Q K^T and dP = dO V^T
//    (wgmma, both operands K-major from shared memory), P = exp2(s scale
//    log2e - lse log2e) in float32 registers and D += P o dP in float32;
//    pass 2 runs S and dP again, forms dS = P o (dP - D) in float32 and
//    only then rounds it to bf16 as the register A operand of dQ += dS K
//    (K read MN-major: the transpose bit).  D is written for launch 2.
//    Five products.  D is taken from the backward's own float32 P and dP,
//    before dS, not as rowsum(dO o O) of the bf16 output and not as
//    A - D B from products of bf16-rounded P o dP and P: both roundings
//    (2^-9) swamp dP - D on rows peaked on one key (flash_attention_bwd.cu
//    has the StarCoder2 case).
// 2. flash_bwd_dkdv_wgmma — a cluster of one or two blocks of two
//    warpgroups per (64-key tile, kv head, batch), the first tiles (the
//    most q rows under the causal mask) first.  K and V arrive once; the
//    steps, (q head of the group, 64-row q tile the mask reaches), go
//    round the cluster's warpgroups, each with its own two-slot ring of Q
//    and dO tiles.  Two blocks a tile when one a tile would fill no more
//    than one wave: StarCoder2's batch-1 call has 128 tiles for 132 SMs,
//    and the first tile's 768 steps (12 heads x 64 q tiles) would bound it
//    at 384 a warpgroup; four warpgroups take 192.  A step runs S^T = K
//    Q^T and dP^T = V dO^T (the key tile is the 64-row A operand, so P^T
//    and dS^T land in the registers in the A-operand layout), reads the
//    rows' lse and D from shared memory, and accumulates dV += P^T dO and
//    dK += dS^T Q with dO and Q read MN-major.  Four products.  At the end the warpgroups' dK
//    and dV are summed through shared memory and then the second block's
//    onto the first's through distributed shared memory, in a fixed order.
// Registers at head dim 128: dK and dV are 64 + 64 float32 a thread, S^T
// and dP^T 32 + 32, their bf16 fragments 16 + 16 — under the 255 a thread
// of a 256-thread block, with no producer warpgroup (the first thread of
// each warpgroup issues its own TMA loads, a tile ahead).  Tiles are 64
// rows so that two m64n64 score accumulators fit beside dK and dV.  Tiles
// above the causal diagonal or left of the window are never read; rows
// and keys past the ends are zero-filled by TMA and masked.  Tensor maps
// are built per call from the strides (any multiple of 16 bytes), so the
// transposed v view of prefill is read in place.
//
// Head dim 256 (Gemma3-4B's windowed and global layers, DeepSeek-V2's MLA
// call padded to 256; `BWD_PLAN` below).  Bound at Gemma3's windowed
// training call (q (1, 8, 4096, 256), kv (1, 4, 4096, 256), window 1,024,
// causal): 75 GFLOP of the five products over the kept pairs, 0.076 ms;
// 50 MB of inputs and outputs, 15 us.  A 64-row tile is 32 KB.
// 1. The dQ launch keeps its plan: Q and dO (64 KB) and two K / V slots
//    (128 KB), 197,656 bytes, so one block an SM.  dQ is m64n256: two
//    n128 products a k16 step on its halves (the register order of one
//    m64n256 fragment, K's boxes 8,192 bytes apart), 128 registers a
//    thread beside S and dP (32 + 32).
// 2. The dK / dV launch cannot keep its plan: dK and dV are 128 float32 a
//    thread each, more than one warpgroup can hold (255), and its ten
//    tiles would be 320 KB.  flash_bwd_dkdv_roles gives the two
//    warpgroups of a block one 64-key tile and every step, by role.
//    Warpgroup 0 runs S^T = K Q^T, forms P^T in float32, hands it to
//    warpgroup 1 through a 16 KB float32 exchange buffer and accumulates
//    dV += P^T dO; warpgroup 1 runs dP^T = V dO^T, forms dS^T = P^T o
//    (dP^T - D) in float32 from the handed P^T, and accumulates dK += dS^T
//    Q.  Four products a step, two on each warpgroup, with the arithmetic
//    of the kernel above; S^T of one warpgroup runs beside dP^T of the
//    other, and dV beside dK.  One buffer, written again only after it was
//    read (two named barriers).  K and V (64 KB) arrive once; one
//    two-slot ring of Q and dO serves both warpgroups (128 KB), a slot
//    freed when both have arrived on its mbarrier, then loaded two steps
//    ahead by warpgroup 1's first thread.  215,080 bytes, no cluster
//    (Gemma3's call has 256 key-tile blocks, MLA's 2,048).  Each
//    warpgroup stores its own sum from registers: nothing to add up
//    between them, so the bits are the same on every run.
// Both launches walk their blocks in rounds of (batch, kv head) groups
// (the plan's order 1): blocks that run together read a few groups' tiles
// and share them in L2, where MLA's 128 one-head groups, a tile of each in
// a wave, read every tile from DRAM.  ptxas (sm_90a): dQ 218 registers,
// dK / dV 224, no spills; one block an SM each.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_bwd.cuh"
#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 64;              // q rows or keys of a tile
constexpr int kBox = kRows * 128;      // bytes of a 64-row x 64-column box
constexpr float kLog2e = 1.4426950408889634f;
#define kInf __int_as_float(0x7f800000)
#define kNegInf __int_as_float(0xff800000)
constexpr int kSmemMax = 232448;       // dynamic shared memory a block may have

// The backward's plan by head dim: BWD_PLAN(head dim, dK / dV by role, Q /
// dO slots of the dK / dV launch, largest cluster of its CTAs, block
// order).  Tiles are 64 rows (q rows or keys) at every head dim, and the
// dQ launch holds Q, dO and two K / V slots.  Role 0: each warpgroup of
// the dK / dV launch takes its own steps and holds dK and dV, with two Q /
// dO slots of its own (four a block), and the key tile's steps spread over
// a cluster of two CTAs when one CTA a tile leaves the grid in one wave.
// Role 1 (head dim 256): the two warpgroups share each step and one ring
// (flash_bwd_dkdv_roles).  Order 0: blocks by tile first (the dQ launch's
// last q tiles, the dK / dV launch's first key tiles: the most work first)
// over all heads and batches.  Order 1 (head dim 256): rounds of (batch,
// kv head) groups, as many groups a round as one wave holds of their
// blocks (at least one), by tile first within a round; the blocks that
// run together then read a few groups' K and V (dQ) or Q and dO (dK / dV)
// and find them in L2, and each round still starts its heaviest blocks
// first.  In order 0 a wave of MLA's 128 one-head groups holds one tile
// of every head, so every read came from DRAM; one group a round left
// Gemma3's global call's heaviest key tiles waiting behind whole groups.  `backward_plan` in
// kernels/flash_attention.py
// gives the same numbers and shared memory: its CPU test reads this table,
// and on the card `built_backward_plan` reads them from `flash_bwd_plan`.
template <int DH>
struct BwdPlan;
#define BWD_PLAN(DH, ROLES, RING, CLUSTER, ORDER)                         \
  template <>                                                             \
  struct BwdPlan<DH> {                                                    \
    static constexpr int kRoles = ROLES, kRing = RING, kCluster = CLUSTER, \
                         kOrder = ORDER;                                  \
  };
BWD_PLAN(64, 0, 4, 2, 0)
BWD_PLAN(128, 0, 4, 2, 0)
BWD_PLAN(256, 1, 2, 1, 1)
#undef BWD_PLAN

// Shared memory of each launch (1024-byte aligned).  dQ: Q, dO and two K
// and V slots, then three barriers.  dK / dV: K, V, the Q / dO ring, the
// float32 P^T exchange (role 1), each warpgroup's lse and D rows, then the
// barriers (K / V, and a full one a slot, with an empty one by role 1).
template <int DH>
struct BwdLayout : BwdPlan<DH> {
  using P = BwdPlan<DH>;
  static constexpr int kTile = DH / 64 * kBox;   // bytes of a 64-row tile
  static constexpr int kSmemDq = 1024 + 6 * kTile + 3 * 8;
  static constexpr int kSmemKv =
      1024 + (2 + 2 * P::kRing) * kTile + (P::kRoles ? kRows * kRows * 4 : 0) +
      2 * 2 * kRows * 4 + 8 * (1 + (P::kRoles ? 2 : 1) * P::kRing);
  static_assert(kSmemDq <= kSmemMax && kSmemKv <= kSmemMax,
                "the backward plan overflows shared memory");
};

// What the two kernels read besides the tensor maps.
struct BwdDims {
  const float* lse;
  float* delta;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int b, hq, hkv, rep, sq, skv, causal, has_window, window;
  int n_qt;             // 64-row q tiles
  int round_dq, round_kv;  // order 1: (batch, kv head) groups a round
  int swaps;            // bit 1 q, 2 k, 4 v, 8 dO: map dims (head, position)
  float scale, scale_log2;
};

// 2^x by the special-function unit (relative error about 2^-22; -inf -> 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ bool kept(int qpos, int key, const BwdDims& p) {
  return key < p.skv && (!p.causal || key <= qpos) &&
         (!p.has_window || key > qpos - p.window);
}

// The 64-row tile at (row, head, b) of a map into `dst`: DH / 64 boxes of
// [64 rows][64 bf16], 128-byte swizzle; the map's middle dims are
// (position, head), or (head, position) when `swap`.
template <int DH>
__device__ __forceinline__ void load_tile(uint32_t dst, const void* map,
                                          uint32_t bar, int row, int head,
                                          int b, int swap) {
#pragma unroll
  for (int h = 0; h < DH / 64; ++h) {
    if (swap)
      sm90::tma_load_4d(dst + h * kBox, map, bar, h * 64, head, row, b);
    else
      sm90::tma_load_4d(dst + h * kBox, map, bar, h * 64, row, head, b);
  }
}

// acc (64 x 64) = A B^T over DH, A and B 64-row tiles (K-major); a k16
// step is 32 bytes into the swizzled 128-byte rows of a box.
template <int DH>
__device__ __forceinline__ void issue_abt(float (&acc)[32], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    sm90::wgmma_ss_m64n64k16(acc, sm90::desc_sw128(a + off, 16, 1024),
                             sm90::desc_sw128(b + off, 16, 1024), kk > 0);
  }
}

// acc (64 x DH) += A B: A (64 x 64) as bf16 register fragments (fragment kk
// holds columns 16 kk .. 16 kk + 15), B a 64-row tile read MN-major (16
// rows = two 8-row swizzle atoms, 2,048 bytes; the dh boxes kBox apart).
// At DH 256 two n128 products a k16 step, on acc's halves.
template <int DH>
__device__ __forceinline__ void issue_ab(float (&acc)[DH / 2],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    const uint64_t db = sm90::desc_sw128(b + kk * 2048, kBox, 1024);
    if constexpr (DH == 256) {     // columns 0-127, then 128-255 (boxes 2, 3)
      sm90::wgmma_rs_m64n128k16(*reinterpret_cast<float(*)[64]>(acc), a[kk],
                                db);
      sm90::wgmma_rs_m64n128k16(
          *reinterpret_cast<float(*)[64]>(acc + 64), a[kk],
          sm90::desc_sw128(b + 2 * kBox + kk * 2048, kBox, 1024));
    } else if constexpr (DH == 128) {
      sm90::wgmma_rs_m64n128k16(acc, a[kk], db);
    } else {
      sm90::wgmma_rs_m64n64k16(acc, a[kk], db);
    }
  }
}

// An m64nN float32 accumulator: register 4 jj + 2 u + e holds row
// 16 (warp % 4) + lane / 4 + 8 u, column 8 jj + 2 (lane % 4) + e; so the
// bf16 A fragment of columns 16 kk .. 16 kk + 15 is registers 8 kk + 2 t,
// 8 kk + 2 t + 1 for t = 0 .. 3 (t % 2 the row half).

// Stores rows rl and rl + 8 (where live) of a 64 x DH accumulator times
// `mul` as bf16 into the contiguous rows at `out` (DH elements a row).
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[DH / 2],
                                           float mul, int rl, const bool (&live)[2]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (!live[u]) continue;
    __nv_bfloat16* row = out + (long long)(rl + 8 * u) * DH + 2 * (lane % 4);
#pragma unroll
    for (int jj = 0; jj < DH / 8; ++jj)
      *reinterpret_cast<uint32_t*>(row + 8 * jj) =
          pack_bf16(acc[4 * jj + 2 * u] * mul, acc[4 * jj + 2 * u + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// 1. dQ and D
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(128, 2) flash_bwd_dq_wgmma(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const BwdDims p) {
  using namespace sm90;
  constexpr int kTile = DH / 64 * kBox;      // bytes of a 64-row tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base, s_do = base + kTile;
  const uint32_t s_k = base + 2 * kTile;     // two slots
  const uint32_t s_v = base + 4 * kTile;     // two slots
  const uint32_t bar_qdo = base + 6 * kTile;
  auto bar_kv = [&](int n) { return bar_qdo + 8u * (1 + (n & 1)); };

  int qt, h, b;
  if constexpr (BwdPlan<DH>::kOrder) {
    // block i: round i / (round_dq n_qt rep) of round_dq groups (fewer in
    // the last), within it q tiles last first, then groups, then q heads
    const int per = p.round_dq * p.n_qt * p.rep, r = blockIdx.x / per;
    const int in_r = min(p.round_dq, p.hkv * p.b - r * p.round_dq);
    const int w = blockIdx.x - r * per, rest = w % (in_r * p.rep);
    const int grp = r * p.round_dq + rest / p.rep;
    qt = p.n_qt - 1 - w / (in_r * p.rep);
    h = grp % p.hkv * p.rep + rest % p.rep;
    b = grp / p.hkv;
  } else {
    // block i: q tile n_qt - 1 - i / (hq b) (the tiles with the most keys
    // first over all heads and batches), head and batch from i % (hq b)
    const int pairs = p.hq * p.b, pair = blockIdx.x % pairs;
    qt = p.n_qt - 1 - blockIdx.x / pairs;
    h = pair % p.hq;
    b = pair / p.hq;
  }
  const int g = h / p.rep;
  const int q0 = qt * kRows, off = p.skv - p.sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p_lo = q0 + off, p_hi = min(q0 + kRows, p.sq) - 1 + off;
  int k_lo = 0, k_hi = p.skv;
  if (p.causal) k_hi = min(k_hi, p_hi + 1);
  if (p.has_window) k_lo = max(k_lo, p_lo - p.window + 1);
  const int t_lo = k_lo / kRows;
  const int n_t = k_hi > k_lo ? (k_hi + kRows - 1) / kRows - t_lo : 0;

  // this thread's rows rl and rl + 8 of the tile: their positions and lse
  // in log2 units (+inf where P is 0: past sq, or no kept key)
  const int rl = warp * 16 + lane / 4;
  const long long row0 = ((long long)b * p.hq + h) * p.sq + q0;
  bool live[2];
  int q_pos[2];
  float lse2[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    live[u] = q0 + rl + 8 * u < p.sq;
    q_pos[u] = q0 + rl + 8 * u + off;
    const float x = live[u] ? p.lse[row0 + rl + 8 * u] : kNegInf;
    lse2[u] = x > kNegInf ? x * kLog2e : kInf;
  }
  float qacc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) qacc[i] = 0.f;
  float dsum[2] = {0.f, 0.f};

  if (n_t > 0) {                             // (uniform over the block)
    if (tid == 0) {
      mbar_init(bar_qdo, 1);
      mbar_init(bar_kv(0), 1);
      mbar_init(bar_kv(1), 1);
      mbar_fence_init();
    }
    __syncthreads();
    const int n_all = 2 * n_t;               // the key tiles of both passes
    auto load_kv = [&](int n) {
      const int kt0 = (t_lo + n % n_t) * kRows;
      const uint32_t slot = (n & 1) * kTile, bar = bar_kv(n);
      mbar_expect_tx(bar, 2 * kTile);
      load_tile<DH>(s_k + slot, &tm_k, bar, kt0, g, b, p.swaps & 2);
      load_tile<DH>(s_v + slot, &tm_v, bar, kt0, g, b, p.swaps & 4);
    };
    if (tid == 0) {
      mbar_expect_tx(bar_qdo, 2 * kTile);
      load_tile<DH>(s_q, &tm_q, bar_qdo, q0, h, b, p.swaps & 1);
      load_tile<DH>(s_do, &tm_do, bar_qdo, q0, h, b, p.swaps & 8);
      load_kv(0);
      load_kv(1);
    }
    mbar_wait(bar_qdo, 0);

    float sacc[32], dpacc[32];
#pragma unroll 1
    for (int n = 0; n < n_all; ++n) {
      const bool second = n >= n_t;
      const int kt0 = (t_lo + (second ? n - n_t : n)) * kRows;
      const uint32_t slot = (n & 1) * kTile;
      mbar_wait(bar_kv(n), (n >> 1) & 1);
      fence_regs(sacc);
      fence_regs(dpacc);
      wgmma_fence();
      issue_abt<DH>(sacc, s_q, s_k + slot);     // S = Q K^T
      issue_abt<DH>(dpacc, s_do, s_v + slot);   // dP = dO V^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(dpacc);

      // P into sacc: exp(s scale - lse) on kept keys, 0 elsewhere
      const bool whole = kt0 + kRows <= p.skv &&
                         (!p.causal || kt0 + kRows - 1 <= p_lo) &&
                         (!p.has_window || kt0 > p_hi - p.window);
#pragma unroll
      for (int jj = 0; jj < kRows / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = e / 2, idx = 4 * jj + e;
          float x = fast_exp2(fmaf(sacc[idx], p.scale_log2, -lse2[u]));
          if (!whole &&
              !kept(q_pos[u], kt0 + 8 * jj + 2 * (lane % 4) + e % 2, p))
            x = 0.f;
          sacc[idx] = x;
        }
      if (!second) {
        // pass 1: D = sum over the row's keys of P dP, in float32
#pragma unroll
        for (int idx = 0; idx < 32; ++idx)
          dsum[(idx / 2) % 2] = fmaf(sacc[idx], dpacc[idx], dsum[(idx / 2) % 2]);
        if (n == n_t - 1) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            dsum[u] += __shfl_xor_sync(0xffffffffu, dsum[u], 1);
            dsum[u] += __shfl_xor_sync(0xffffffffu, dsum[u], 2);
          }
        }
      } else {
        // pass 2: dS = P (dP - D) in float32, then bf16; dQ += dS K
        uint32_t da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int idx = 8 * kk + 2 * t, u = t % 2;
            da[kk][t] = pack_bf16(sacc[idx] * (dpacc[idx] - dsum[u]),
                                  sacc[idx + 1] * (dpacc[idx + 1] - dsum[u]));
          }
        fence_regs(qacc);
        wgmma_fence();
        issue_ab<DH>(qacc, da, s_k + slot);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(qacc);
      }
      __syncthreads();                         // every warp is done with the slot
      if (tid == 0 && n + 2 < n_all) load_kv(n + 2);
    }
  }

  // dQ = scale dS K and D, where live (rows with no key: 0)
  store_rows<DH>(p.dq + row0 * DH, qacc, p.scale, rl, live);
  if (lane % 4 == 0) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (live[u]) p.delta[row0 + rl + 8 * u] = dsum[u];
  }
}

// ---------------------------------------------------------------------------
// 2. dK and dV
// ---------------------------------------------------------------------------

// A cluster of C CTAs (1 or 2, the launcher's choice) serves one (key
// tile, kv head, batch); the block's steps go round the C x 2 warpgroups,
// whose sums meet in CTA 0 in a fixed order.
template <int DH>
__global__ void __launch_bounds__(256, 1) flash_bwd_dkdv_wgmma(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const BwdDims p) {
  using namespace sm90;
  constexpr int kTile = DH / 64 * kBox;
  constexpr int kNO = DH / 2;                // dK (and dV) registers a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_k = base, s_v = base + kTile;
  // warpgroup w's slot j: Q at s_ring + (4 w + 2 j) kTile, dO after it
  const uint32_t s_ring = base + 2 * kTile;
  const uint32_t s_stat = s_ring + 8 * kTile;  // per warpgroup: lse2, D
  const uint32_t s_bar = s_stat + 2 * 2 * kRows * 4;
  auto full = [&](int w, int m) { return s_bar + 8u * (1 + 2 * w + (m & 1)); };

  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  // cluster i: key tile i / (hkv b) (the first tiles, with the most q rows
  // under the causal mask, first), kv head and batch from i % (hkv b)
  const int pairs = p.hkv * p.b, item = blockIdx.x / n_cta;
  const int kt = item / pairs, kvh = item % pairs % p.hkv;
  const int b = item % pairs / p.hkv;
  const int k0 = kt * kRows, nk = min(kRows, p.skv - k0), off = p.skv - p.sq;
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int lane_of = rank * 2 + wg, n_lanes = n_cta * 2;  // step lanes
  const int warp = wt / 32, lane = tid % 32;
  // the q rows whose mask keeps a key of the tile: [i_lo, i_hi)
  int i_lo = 0, i_hi = p.sq;
  if (p.causal) i_lo = max(0, k0 - off);
  if (p.has_window) i_hi = min(p.sq, k0 + nk - 1 + p.window - off);
  const int qt_lo = i_lo / kRows;
  const int n_qt = i_hi > i_lo ? (i_hi + kRows - 1) / kRows - qt_lo : 0;
  const int n_steps = p.rep * n_qt;          // (q head, q tile) pairs
  const int my_steps =
      n_steps > lane_of ? (n_steps - lane_of + n_lanes - 1) / n_lanes : 0;
  const int rl = warp * 16 + lane / 4;       // keys rl, rl + 8 of the tile

  float kacc[kNO], vacc[kNO];
#pragma unroll
  for (int i = 0; i < kNO; ++i) kacc[i] = vacc[i] = 0.f;

  if (n_steps > 0) {                         // (uniform over the block)
    if (tid == 0) {
      mbar_init(s_bar, 1);
      for (int i = 0; i < 4; ++i) mbar_init(s_bar + 8u * (1 + i), 1);
      mbar_fence_init();
    }
    __syncthreads();
    // this warpgroup's m-th step is the block's step lane_of + n_lanes m
    auto step_of = [&](int m, int& h, int& q0) {
      const int s = lane_of + n_lanes * m, gl = s / n_qt;
      h = kvh * p.rep + gl;
      q0 = (qt_lo + s - gl * n_qt) * kRows;
    };
    auto load_step = [&](int m) {
      int h, q0;
      step_of(m, h, q0);
      const uint32_t dst = s_ring + (4 * wg + 2 * (m & 1)) * kTile;
      mbar_expect_tx(full(wg, m), 2 * kTile);
      load_tile<DH>(dst, &tm_q, full(wg, m), q0, h, b, p.swaps & 1);
      load_tile<DH>(dst + kTile, &tm_do, full(wg, m), q0, h, b, p.swaps & 8);
    };
    if (tid == 0) {
      mbar_expect_tx(s_bar, 2 * kTile);
      load_tile<DH>(s_k, &tm_k, s_bar, k0, kvh, b, p.swaps & 2);
      load_tile<DH>(s_v, &tm_v, s_bar, k0, kvh, b, p.swaps & 4);
    }
    if (wt == 0) {
      if (my_steps > 0) load_step(0);
      if (my_steps > 1) load_step(1);
    }
    float* lse_s =
        reinterpret_cast<float*>(smem_raw + (s_stat - raw)) + wg * 2 * kRows;
    float* d_s = lse_s + kRows;
    mbar_wait(s_bar, 0);

    float sacc[32], dpacc[32];
#pragma unroll 1
    for (int m = 0; m < my_steps; ++m) {
      int h, q0;
      step_of(m, h, q0);
      const long long row0 = ((long long)b * p.hq + h) * p.sq + q0;
      {  // the step's lse (log2 units, +inf: P = 0) and D into shared memory
        const int i = wt % kRows;
        const bool live = q0 + i < p.sq;
        if (wt < kRows) {
          const float x = live ? p.lse[row0 + i] : kNegInf;
          lse_s[i] = x > kNegInf ? x * kLog2e : kInf;
        } else {
          d_s[i] = live ? p.delta[row0 + i] : 0.f;
        }
      }
      const uint32_t q_t = s_ring + (4 * wg + 2 * (m & 1)) * kTile;
      const uint32_t do_t = q_t + kTile;
      mbar_wait(full(wg, m), (m >> 1) & 1);
      fence_regs(sacc);
      fence_regs(dpacc);
      wgmma_fence();
      issue_abt<DH>(sacc, s_k, q_t);          // S^T = K Q^T
      issue_abt<DH>(dpacc, s_v, do_t);        // dP^T = V dO^T
      wgmma_commit();
      bar_sync(1 + wg, 128);                  // lse and D in place
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(dpacc);

      // P^T and dS^T = P^T o (dP^T - D) as bf16 A fragments: row = key
      // k0 + rl + 8 u, column = q row q0 + col
      const int p_hi = min(q0 + kRows, p.sq) - 1 + off;
      const bool whole = k0 + kRows <= p.skv &&
                         (!p.causal || k0 + kRows - 1 <= q0 + off) &&
                         (!p.has_window || k0 > p_hi - p.window);
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int idx = 8 * kk + 2 * t, u = t % 2;
          const int col = 16 * kk + 8 * (t / 2) + 2 * (lane % 4);
          float p0 = fast_exp2(fmaf(sacc[idx], p.scale_log2, -lse_s[col]));
          float p1 =
              fast_exp2(fmaf(sacc[idx + 1], p.scale_log2, -lse_s[col + 1]));
          if (!whole) {
            const int key = k0 + rl + 8 * u, qpos = q0 + col + off;
            if (!kept(qpos, key, p)) p0 = 0.f;
            if (!kept(qpos + 1, key, p)) p1 = 0.f;
          }
          pa[kk][t] = pack_bf16(p0, p1);
          da[kk][t] = pack_bf16(p0 * (dpacc[idx] - d_s[col]),
                                p1 * (dpacc[idx + 1] - d_s[col + 1]));
        }
      fence_regs(kacc);
      fence_regs(vacc);
      wgmma_fence();
      issue_ab<DH>(vacc, pa, do_t);           // dV += P^T dO
      issue_ab<DH>(kacc, da, q_t);            // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(kacc);
      fence_regs(vacc);
      bar_sync(1 + wg, 128);                  // the slot and the stats free
      if (wt == 0 && m + 2 < my_steps) load_step(m + 2);
    }
  }

  // warpgroup 1's sums onto warpgroup 0's through shared memory (the ring
  // is free), then the other CTAs' onto CTA 0's through distributed shared
  // memory, in that order: the same bits on every run
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw + (s_ring - raw));
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < kNO; ++i) {
      red[i * 128 + wt] = kacc[i];
      red[(kNO + i) * 128 + wt] = vacc[i];
    }
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < kNO; ++i) {
      kacc[i] += red[i * 128 + wt];
      vacc[i] += red[(kNO + i) * 128 + wt];
      red[i * 128 + wt] = kacc[i];
      red[(kNO + i) * 128 + wt] = vacc[i];
    }
  }
  cluster.sync();                            // every CTA's sum in place
  if (rank == 0 && wg == 0) {
    for (int r = 1; r < n_cta; ++r) {
      const float* other = cluster.map_shared_rank(red, r);
#pragma unroll
      for (int i = 0; i < kNO; ++i) {
        kacc[i] += other[i * 128 + wt];
        vacc[i] += other[(kNO + i) * 128 + wt];
      }
    }
  }
  cluster.sync();                            // the other CTAs' sums are read
  if (rank != 0 || wg == 1) return;
  const bool live[2] = {rl < nk, rl + 8 < nk};
  const long long kv_row0 = ((long long)b * p.hkv + kvh) * p.skv + k0;
  store_rows<DH>(p.dk + kv_row0 * DH, kacc, p.scale, rl, live);
  store_rows<DH>(p.dv + kv_row0 * DH, vacc, 1.f, rl, live);
}

// ---------------------------------------------------------------------------
// 2b. dK and dV by role (head dim 256)
// ---------------------------------------------------------------------------

// A block of two warpgroups per (64-key tile, kv head, batch), in rounds
// of groups; both take every step (q head of the group, 64-row q tile the
// mask reaches): warpgroup 0 forms P^T and sums dV, warpgroup 1 forms dS^T
// from the P^T it is handed and sums dK.
template <int DH>
__global__ void __launch_bounds__(256, 1) flash_bwd_dkdv_roles(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const BwdDims p) {
  using namespace sm90;
  using L = BwdLayout<DH>;
  constexpr int kTile = L::kTile, kRing = L::kRing;
  constexpr int kNO = DH / 2;                // dV or dK registers a thread
  constexpr int kHanded = 3, kFree = 4;      // named barriers of the exchange
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_k = base, s_v = base + kTile;
  const uint32_t s_ring = base + 2 * kTile;  // slot j: Q, then dO
  const uint32_t s_x = s_ring + 2 * kRing * kTile;   // P^T, float32
  const uint32_t s_stat = s_x + kRows * kRows * 4;   // per warpgroup
  const uint32_t s_bar = s_stat + 2 * 2 * kRows * 4;
  auto full = [&](int m) { return s_bar + 8u * (1 + m % kRing); };
  auto empty = [&](int m) { return s_bar + 8u * (1 + kRing + m % kRing); };

  // block i: round i / (round_kv n_kt) of round_kv groups (fewer in the
  // last), within it the first key tiles (the most q rows under the
  // causal mask) first, then groups: the plan's order 1
  static_assert(L::kOrder == 1, "flash_bwd_dkdv_roles walks in rounds");
  const int n_kt = (p.skv + kRows - 1) / kRows;
  const int per = p.round_kv * n_kt, r = blockIdx.x / per;
  const int in_r = min(p.round_kv, p.hkv * p.b - r * p.round_kv);
  const int w = blockIdx.x - r * per, kt = w / in_r;
  const int grp = r * p.round_kv + w % in_r;
  const int kvh = grp % p.hkv, b = grp / p.hkv;
  const int k0 = kt * kRows, nk = min(kRows, p.skv - k0), off = p.skv - p.sq;
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = tid % 32;
  // the q rows whose mask keeps a key of the tile: [i_lo, i_hi)
  int i_lo = 0, i_hi = p.sq;
  if (p.causal) i_lo = max(0, k0 - off);
  if (p.has_window) i_hi = min(p.sq, k0 + nk - 1 + p.window - off);
  const int qt_lo = i_lo / kRows;
  const int n_qt = i_hi > i_lo ? (i_hi + kRows - 1) / kRows - qt_lo : 0;
  const int n_steps = p.rep * n_qt;          // (q head, q tile) pairs
  const int rl = warp * 16 + lane / 4;       // keys rl, rl + 8 of the tile

  float acc[kNO];                            // warpgroup 0: dV; 1: dK
#pragma unroll
  for (int i = 0; i < kNO; ++i) acc[i] = 0.f;

  if (n_steps > 0) {                         // (uniform over the block)
    if (tid == 0) {
      mbar_init(s_bar, 1);
      for (int j = 0; j < kRing; ++j) {
        mbar_init(full(j), 1);
        mbar_init(empty(j), 2);              // one thread of each warpgroup
      }
      mbar_fence_init();
    }
    __syncthreads();
    auto step_of = [&](int m, int& h, int& q0) {
      const int gl = m / n_qt;
      h = kvh * p.rep + gl;
      q0 = (qt_lo + m - gl * n_qt) * kRows;
    };
    auto load_step = [&](int m) {
      int h, q0;
      step_of(m, h, q0);
      const uint32_t dst = s_ring + 2 * (m % kRing) * kTile;
      mbar_expect_tx(full(m), 2 * kTile);
      load_tile<DH>(dst, &tm_q, full(m), q0, h, b, p.swaps & 1);
      load_tile<DH>(dst + kTile, &tm_do, full(m), q0, h, b, p.swaps & 8);
    };
    if (tid == 0) {
      mbar_expect_tx(s_bar, 2 * kTile);
      load_tile<DH>(s_k, &tm_k, s_bar, k0, kvh, b, p.swaps & 2);
      load_tile<DH>(s_v, &tm_v, s_bar, k0, kvh, b, p.swaps & 4);
      for (int m = 0; m < kRing && m < n_steps; ++m) load_step(m);
    }
    // warpgroup 0's step rows' lse (log2 units, +inf: P = 0), warpgroup
    // 1's D; the exchange holds P^T in the accumulator's register order
    float* stat =
        reinterpret_cast<float*>(smem_raw + (s_stat - raw)) + wg * 2 * kRows;
    float* xch = reinterpret_cast<float*>(smem_raw + (s_x - raw));
    mbar_wait(s_bar, 0);

    float sacc[32];                          // S^T (warpgroup 0), dP^T (1)
#pragma unroll 1
    for (int m = 0; m < n_steps; ++m) {
      int h, q0;
      step_of(m, h, q0);
      const long long row0 = ((long long)b * p.hq + h) * p.sq + q0;
      if (wt < kRows) {
        const bool live = q0 + wt < p.sq;
        if (wg == 0) {
          const float x = live ? p.lse[row0 + wt] : kNegInf;
          stat[wt] = x > kNegInf ? x * kLog2e : kInf;
        } else {
          stat[wt] = live ? p.delta[row0 + wt] : 0.f;
        }
      }
      const uint32_t q_t = s_ring + 2 * (m % kRing) * kTile;
      const uint32_t do_t = q_t + kTile;
      mbar_wait(full(m), (m / kRing) & 1);
      fence_regs(sacc);
      wgmma_fence();
      issue_abt<DH>(sacc, wg == 0 ? s_k : s_v, wg == 0 ? q_t : do_t);
      wgmma_commit();
      bar_sync(1 + wg, 128);                  // the step's rows in place
      wgmma_wait<0>();
      fence_regs(sacc);

      // P^T (warpgroup 0) or dS^T (1) as bf16 A fragments: row = key
      // k0 + rl + 8 u, column = q row q0 + col
      uint32_t fa[4][4];
      if (wg == 0) {
        const int p_hi = min(q0 + kRows, p.sq) - 1 + off;
        const bool whole = k0 + kRows <= p.skv &&
                           (!p.causal || k0 + kRows - 1 <= q0 + off) &&
                           (!p.has_window || k0 > p_hi - p.window);
        if (m > 0) bar_sync(kFree, 256);      // step m - 1's P^T was read
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int idx = 8 * kk + 2 * t, u = t % 2;
            const int col = 16 * kk + 8 * (t / 2) + 2 * (lane % 4);
            float p0 = fast_exp2(fmaf(sacc[idx], p.scale_log2, -stat[col]));
            float p1 =
                fast_exp2(fmaf(sacc[idx + 1], p.scale_log2, -stat[col + 1]));
            if (!whole) {
              const int key = k0 + rl + 8 * u, qpos = q0 + col + off;
              if (!kept(qpos, key, p)) p0 = 0.f;
              if (!kept(qpos + 1, key, p)) p1 = 0.f;
            }
            xch[idx * 128 + wt] = p0;
            xch[(idx + 1) * 128 + wt] = p1;
            fa[kk][t] = pack_bf16(p0, p1);
          }
        bar_arrive(kHanded, 256);
      } else {
        bar_sync(kHanded, 256);               // this step's P^T written
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int idx = 8 * kk + 2 * t;
            const int col = 16 * kk + 8 * (t / 2) + 2 * (lane % 4);
            fa[kk][t] =
                pack_bf16(xch[idx * 128 + wt] * (sacc[idx] - stat[col]),
                          xch[(idx + 1) * 128 + wt] *
                              (sacc[idx + 1] - stat[col + 1]));
          }
        if (m + 1 < n_steps) bar_arrive(kFree, 256);
      }
      fence_regs(acc);
      wgmma_fence();
      issue_ab<DH>(acc, fa, wg == 0 ? do_t : q_t);  // dV += P^T dO; dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      bar_sync(1 + wg, 128);                  // done with the slot and rows
      if (wt == 0) {
        mbar_arrive(empty(m));
        if (wg == 1 && m + kRing < n_steps) {
          mbar_wait(empty(m), (m / kRing) & 1);  // both warpgroups are
          load_step(m + kRing);
        }
      }
    }
  }

  const bool live[2] = {rl < nk, rl + 8 < nk};
  const long long kv_row0 = ((long long)b * p.hkv + kvh) * p.skv + k0;
  if (wg == 0)
    store_rows<DH>(p.dv + kv_row0 * DH, acc, 1.f, rl, live);
  else
    store_rows<DH>(p.dk + kv_row0 * DH, acc, p.scale, rl, live);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename Kern>
cudaError_t allow_smem(Kern kern, bool& done, size_t bytes) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

template <int DH>
cudaError_t launch(const BwdArgs& a) {
  const sm90::EncodeTiled enc = sm90::encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  BwdDims p;
  p.swaps = 0;
  // a map of (rows, heads) 64-row tiles, its middle dims in the order of
  // their strides (the smaller first)
  auto map = [&](CUtensorMap* m, const void* ptr, const long long* st,
                 int heads, int rows, int bit) {
    if (st[1] < st[2]) {
      p.swaps |= bit;
      return sm90::tensor_map(enc, m, ptr, DH, heads, rows, a.b, st[1], st[2],
                              st[0], 1, kRows);
    }
    return sm90::tensor_map(enc, m, ptr, DH, rows, heads, a.b, st[2], st[1],
                            st[0], kRows, 1);
  };
  CUtensorMap tq, tk, tv, tdo;
  if (!(map(&tq, a.q, a.st_q, a.hq, a.sq, 1) &&
        map(&tk, a.k, a.st_k, a.hkv, a.skv, 2) &&
        map(&tv, a.v, a.st_v, a.hkv, a.skv, 4) &&
        map(&tdo, a.dout, a.st_do, a.hq, a.sq, 8)))
    return cudaErrorInvalidValue;
  p.b = a.b;
  p.n_qt = (a.sq + kRows - 1) / kRows;
  p.lse = a.lse;
  p.delta = a.delta;
  p.dq = static_cast<__nv_bfloat16*>(a.dq);
  p.dk = static_cast<__nv_bfloat16*>(a.dk);
  p.dv = static_cast<__nv_bfloat16*>(a.dv);
  p.hq = a.hq;
  p.hkv = a.hkv;
  p.rep = a.hq / a.hkv;
  p.sq = a.sq;
  p.skv = a.skv;
  p.causal = a.causal;
  p.has_window = a.has_window;
  p.window = a.window;
  p.scale = static_cast<float>(a.scale);
  p.scale_log2 = static_cast<float>(a.scale * 1.4426950408889634);

  using L = BwdLayout<DH>;
  static bool dq_set = false, kv_set = false;
  cudaError_t err = allow_smem(flash_bwd_dq_wgmma<DH>, dq_set, L::kSmemDq);
  if (err != cudaSuccess) return err;
  if constexpr (L::kRoles)
    err = allow_smem(flash_bwd_dkdv_roles<DH>, kv_set, L::kSmemKv);
  else
    err = allow_smem(flash_bwd_dkdv_wgmma<DH>, kv_set, L::kSmemKv);
  if (err != cudaSuccess) return err;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int n_kt = (a.skv + kRows - 1) / kRows, groups = a.hkv * a.b;
  // order 1: as many groups a round as one wave holds of their blocks
  p.round_dq = min(groups, max(1, n_sm / (p.n_qt * p.rep)));
  p.round_kv = min(groups, max(1, n_sm / n_kt));
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  flash_bwd_dq_wgmma<DH><<<p.n_qt * a.hq * a.b, 128, L::kSmemDq, st>>>(
      tq, tk, tv, tdo, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int items = n_kt * groups;
  if constexpr (L::kRoles) {
    flash_bwd_dkdv_roles<DH><<<items, 256, L::kSmemKv, st>>>(tq, tk, tv, tdo,
                                                            p);
  } else {
    // two CTAs a key tile when one a tile leaves the card in one wave (the
    // first tiles' causal work then splits four ways, not two)
    const int n_cta = items <= n_sm ? L::kCluster : 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(items * n_cta));
    cfg.blockDim = dim3(256);
    cfg.dynamicSmemBytes = L::kSmemKv;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n_cta;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, flash_bwd_dkdv_wgmma<DH>, tq, tk, tv, tdo,
                             p);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The backward of one bf16 attention call at head dim 64, 128 or 256: the
// arguments of flash_attention_backward_launch (flash_attention_bwd.cu),
// with every pointer and every stride of q, k, v and dout 16-byte aligned
// (TMA), lse the forward's and delta b * hq * sq float32 workspace.  Two
// launches on `stream`; returns the first CUDA error (0 on success).
int flash_attention_backward_wgmma_launch(const void* args) {
  const BwdArgs& a = *static_cast<const BwdArgs*>(args);
  if (!a.is_bf16 || a.b < 1 || a.hq < 1 || a.hkv < 1 || a.hq % a.hkv ||
      a.sq < 1 || a.skv < 1 || a.lse == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (a.dh == 64) err = launch<64>(a);
  if (a.dh == 128) err = launch<128>(a);
  if (a.dh == 256) err = launch<256>(a);
  return static_cast<int>(err);
}

// The backward's plan at head dim dh as it is built: out gets rows of a
// tile, dK / dV by role (0 or 1), the Q / dO slots of the dK / dV launch,
// its largest cluster, the block order (0 or 1), and the dynamic shared
// memory of the dQ and of the dK / dV launch.  Returns 0, or cudaErrorInvalidValue for a head dim the
// route is not built for.
int flash_bwd_plan(int dh, int* out) {
#define BWD_CASE(D)                                                         \
  if (dh == D) {                                                            \
    using L = BwdLayout<D>;                                                 \
    const int plan[7] = {kRows,     L::kRoles,  L::kRing,  L::kCluster,     \
                         L::kOrder, L::kSmemDq, L::kSmemKv};                \
    for (int i = 0; i < 7; ++i) out[i] = plan[i];                           \
    return 0;                                                               \
  }
  BWD_CASE(64) BWD_CASE(128) BWD_CASE(256)
#undef BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Size of BwdArgs, for the wrapper to check its packing against.
int flash_attention_backward_wgmma_args_size() {
  return (int)sizeof(BwdArgs);
}

// Human-readable name of a CUDA error code returned by the launcher.
const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
