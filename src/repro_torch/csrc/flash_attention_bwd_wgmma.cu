// Backward of the fused attention on the tensor cores, for Hopper (sm_90a):
// route `bwd_wgmma` of kernels/flash_attention.py, bf16 q, k, v and dO at
// head dim 64 or 128.  Other calls (head dim 16, 32, 256; float32) take
// route `bwd_fma` (flash_attention_bwd.cu).
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

// What the two kernels read besides the tensor maps.
struct BwdDims {
  const float* lse;
  float* delta;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int b, hq, hkv, rep, sq, skv, causal, has_window, window;
  int n_qt;             // 64-row q tiles
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
template <int DH>
__device__ __forceinline__ void issue_ab(float (&acc)[DH / 2],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    const uint64_t db = sm90::desc_sw128(b + kk * 2048, kBox, 1024);
    if constexpr (DH == 128)
      sm90::wgmma_rs_m64n128k16(acc, a[kk], db);
    else
      sm90::wgmma_rs_m64n64k16(acc, a[kk], db);
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

  // block i: q tile n_qt - 1 - i / (hq b) (the tiles with the most keys
  // first over all heads and batches), head and batch from i % (hq b)
  const int pairs = p.hq * p.b, pair = blockIdx.x % pairs;
  const int qt = p.n_qt - 1 - blockIdx.x / pairs;
  const int h = pair % p.hq, b = pair / p.hq, g = h / p.rep;
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

  constexpr size_t kTile = DH / 64 * kBox;
  const size_t smem_dq = 1024 + 6 * kTile + 3 * 8;
  const size_t smem_kv = 1024 + 10 * kTile + 2 * 2 * kRows * 4 + 5 * 8;
  static bool dq_set = false, kv_set = false;
  cudaError_t err = allow_smem(flash_bwd_dq_wgmma<DH>, dq_set, smem_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dkdv_wgmma<DH>, kv_set, smem_kv);
  if (err != cudaSuccess) return err;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  flash_bwd_dq_wgmma<DH><<<p.n_qt * a.hq * a.b, 128, smem_dq, st>>>(
      tq, tk, tv, tdo, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // two CTAs a key tile when one a tile leaves the card in one wave (the
  // first tiles' causal work then splits four ways, not two)
  const int items = (a.skv + kRows - 1) / kRows * a.hkv * a.b;
  const int n_cta = items <= n_sm ? 2 : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(items * n_cta));
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem_kv;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_cta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_dkdv_wgmma<DH>, tq, tk, tv, tdo, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The backward of one bf16 attention call at head dim 64 or 128: the
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
  return static_cast<int>(err);
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
