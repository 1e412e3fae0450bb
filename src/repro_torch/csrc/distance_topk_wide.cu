// Stage-0 truncated-L2 scan with top-k over float32 rows wider than 256
// dims, on the tensor cores of Hopper (sm_90a): route `wide` of
// kernels/distance_topk.py.
//
// Replaces, with csrc/distance_topk.cuh's `wgmma` (dims up to 256) and
// `fma` (rows TMA cannot read, bf16 above 256 dims), the TPU kernel
// `l2_topk` of the JAX package (src/repro/kernels/distance_topk.py:128):
// score every stored row against a batch of queries over the first `dim`
// dims and keep each query's best k, without writing the (Q, N) score
// matrix anywhere.  Its main callers are the paper's truncated baselines
// and the progressive searches whose stage 0 starts at 512 dims
// (launch/paper_tables.py: Table II / III, Fig. 3 at 1M x 3,584 rows and
// 2,470 queries).
//
// Bound on an H100 SXM: the operations.  At 2,470 queries, 1M rows and
// 3,584 dims the scan is 17.7 TFLOP as float32; the three TF32 products
// below make 53 TFLOP, 107 ms at the dense 495 TFLOP/s, against 4.3 ms to
// read the rows once.  So the kernel lives on the tensor cores and must
// keep them fed: its bytes are the row and query boxes it reads from L2.
//
// Design.  The `wgmma` kernel keeps a query tile's TF32 hi and lo parts
// whole in shared memory, which caps it at 256 dims.  Here the dims are a
// K loop instead, and nothing in shared memory grows with dim:
//   - A pre-pass (wide_split_queries) splits the queries once a call into
//     TF32 hi = tf32(v) and lo = tf32(v - hi) in a scratch buffer, already
//     in the layout of a 128-byte-swizzled wgmma B box (queries x 32 dims,
//     dims permuted by `logical_k`), one (hi, lo) pair of boxes per (query
//     tile, 32-dim box), contiguous.
//   - One thread of a producer warpgroup streams, into a ring of mbarrier
//     stages, a tile's rows (a TMA box of 128 rows x 32 dims, 128-byte
//     swizzle, from a 2-d tensor map over (n, ld_db)) beside the query
//     tile's hi and lo boxes of the same dims (one bulk copy).  The
//     warpgroup gives its registers to the consumers (setmaxnreg): at the
//     168 a thread of the launch, the float32 sums below spilled.
//   - Two consumer warpgroups take 64 rows each (the M side); the query
//     tile is the N side.  A row value is split in registers into hi and lo
//     and the product is hi*hi + hi*lo + lo*hi in float32 accumulators
//     (`scores_3xtf32` in the wrapper).  The (rows x queries) sums stay in
//     registers across the whole dim loop: the tensor cores' accumulators
//     restart every 4 boxes and are then added to them in float32, each add
//     rounded to nearest (over a whole 3,584-dim row the tensor cores' own
//     sums drift past the plain version's tolerance).  A stage is released
//     when its products are done (the query boxes are read by the tensor
//     cores from the stage itself).
//   - After a tile's last box the selection of csrc/l2_select.cuh runs
//     once: score = sq - 2 acc (norms from `sq_at_dim` or summed from the
//     rows on the way), invalid rows dropped, a threshold test in registers,
//     survivors appended to their query's list in shared memory, the lists
//     tightened when one could overflow on the next tile, and at the end of
//     a work item `emit`.  Its cost is paid once a 128-row tile, not once a
//     32-dim box.
//   - Lists are sized by k (`WIDE_PLAN`): at k <= 64 (Table II's 1, Table
//     III's 16 and 64) a block holds 64 queries in lists of 256 slots; up
//     to k = 1,024 (Fig. 3's k0) 8 queries in lists of 2,048, as `wgmma`.
//     Lists of 512 slots are tightened and emitted by the register
//     networks, the others by the shared-memory versions.
//   - The grid is persistent: one block an SM walks (row range, query tile)
//     items doc-major (item = split * q_tiles + query tile; the ranges
//     differ by at most one 128-row tile), so the blocks in flight read the
//     same row ranges and all but one of them find the rows in L2.  Each
//     item writes its sorted top k of the range to a (Q, n_split, k)
//     scratch, and pass 2 (l2_select.cuh) folds the ranges.
// Ties order by (score, row index); slots with no finite score return (+inf,
// -1); the result does not depend on the number of splits.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "l2_select.cuh"
#include "sm90.cuh"

namespace {

namespace wd {
constexpr int kWgs = 2;                    // consumer warpgroups
constexpr int kRows = 64 * kWgs;           // rows of a tile
constexpr int kConsumers = 128 * kWgs;
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kWarps = 4 * kWgs;           // consumer warps
constexpr int kBox = 32;                   // float32 dims of a 128-byte box
constexpr int kRowBytes = kRows * 128;     // a stage's rows
constexpr int kSmemMax = 232448;           // dynamic shared memory a block
constexpr int kSplitThreads = 256;         // the query pre-pass
constexpr int kFold = 4;                   // boxes (128 dims) a register fold
}  // namespace wd

// The plan by k: WIDE_PLAN(largest k, queries a tile, slots a list, ring
// stages).  `wide_plan` in kernels/distance_topk.py mirrors this table
// (its CPU test reads it from here), and on the card `built_wide_plan`
// asks the library (`l2_topk_wide_plan`).  A list needs room for k and a
// whole tile of candidates (128) above it; 64 lists of 256 slots (128 KB)
// leave three stages of 32 KB (rows, query hi, query lo), and each larger
// class halves the tile as it doubles the lists.  A batch smaller than the
// tile takes the smallest of 8, 16, 32, 64 that holds it.
struct WidePlan {
  int max_k, tile, slots, stages;
};
constexpr WidePlan kWidePlans[] = {
#define WIDE_PLAN(MAXK, TILE, SLOTS, STAGES) {MAXK, TILE, SLOTS, STAGES},
WIDE_PLAN(64, 64, 256, 3)
WIDE_PLAN(256, 32, 512, 4)
WIDE_PLAN(512, 16, 1024, 4)
WIDE_PLAN(1024, 8, 2048, 5)
#undef WIDE_PLAN
};
constexpr int kNumPlans = sizeof(kWidePlans) / sizeof(kWidePlans[0]);

// Dynamic shared memory of a block: 1,024 bytes of alignment, the ring
// (rows, query hi, query lo a stage), the lists, their counts and
// thresholds, the barriers.
__host__ __device__ constexpr size_t wide_smem_bytes(int tile, int slots,
                                                     int stages) {
  return 1024 + (size_t)stages * (wd::kRowBytes + 2 * tile * 128) +
         (size_t)tile * slots * 8 + (size_t)tile * 12 + 8 +
         (size_t)stages * 16;
}

constexpr bool plans_fit() {
  for (int i = 0; i < kNumPlans; ++i)
    if (wide_smem_bytes(kWidePlans[i].tile, kWidePlans[i].slots,
                        kWidePlans[i].stages) > wd::kSmemMax ||
        kWidePlans[i].slots < kWidePlans[i].max_k + wd::kRows)
      return false;
  return true;
}
static_assert(plans_fit(), "a wide plan overflows shared memory or its lists");

// The plan of a call of nq queries at k: false above the table's last k.
inline bool wide_plan(int nq, int k, int* tile, int* slots, int* stages) {
  for (int i = 0; i < kNumPlans; ++i) {
    if (k > kWidePlans[i].max_k) continue;
    int t = 8;
    while (t < nq && t < kWidePlans[i].tile) t *= 2;
    *tile = t;
    *slots = kWidePlans[i].slots;
    *stages = kWidePlans[i].stages;
    return true;
  }
  return false;
}

// The queries as the scan's B boxes: out[(qt * nbox + b) * 2 + part] is a
// (tile x 32) box of query tile qt, dims 32 b .., part 0 TF32 hi and 1 lo,
// each row 128 bytes under the 128-byte swizzle with its dims permuted by
// `logical_k`; zero past nq and dim.
__global__ void __launch_bounds__(wd::kSplitThreads)
wide_split_queries(const float* __restrict__ q, long long ld_q, int nq,
                   int dim, int tile, int nbox, long long total,
                   float* __restrict__ out) {
  for (long long e = blockIdx.x * (long long)wd::kSplitThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * wd::kSplitThreads) {
    const int kp = (int)(e % wd::kBox);
    const long long r = e / wd::kBox;
    const int nn = (int)(r % tile);
    const long long tb = r / tile;                 // qt * nbox + b
    const int b = (int)(tb % nbox), qt = (int)(tb / nbox);
    const int gq = qt * tile + nn, gd = b * wd::kBox + kp;
    const float v = gq < nq && gd < dim ? q[gq * ld_q + gd] : 0.f;
    const float hi = sm90::tf32_round(v);
    float* box = out + tb * 2 * tile * wd::kBox;
    const int off = swz128(nn, logical_k(kp)) / 4;
    box[off] = hi;
    box[tile * wd::kBox + off] = sm90::tf32_round(v - hi);
  }
}

// The first tile of row range `split` of n_split: the ranges differ by at
// most one tile.
__device__ __forceinline__ int split_begin(int split, int n_tiles,
                                           int n_split) {
  return (int)((long long)split * n_tiles / n_split);
}

// A list's tighten and emit: the register networks for lists of kSlots,
// the shared-memory versions for the others.
__device__ __forceinline__ Tight tighten_any(float* s, int* id, int cnt,
                                             int k, int room, int sp) {
  return sp == kSlots ? tighten(s, id, cnt, k, room)
                      : tighten_big(s, id, cnt, k, room, sp);
}

__device__ __forceinline__ void emit_any(float* s, int* id, int cnt, int k,
                                         int sp, float* out_s, int* out_i) {
  if (sp == kSlots) emit_sorted(s, id, cnt, k, out_s, out_i);
  else emit_sorted_big(s, id, cnt, k, out_s, out_i);
}

// Pass 1.  grid = the SMs (at most the items), block = two consumer
// warpgroups (warps 0-7) and a producer warpgroup (warps 8-11), which
// gives the consumers its registers (setmaxnreg: 240 a consumer thread);
// NQ queries a tile.
template <int NQ, bool HAS_SQ>
__global__ void __launch_bounds__(wd::kThreads, 1)
l2_scan_wide_kernel(const __grid_constant__ CUtensorMap tm_db,
                    const float* __restrict__ qsplit,
                    const float* __restrict__ sq,
                    const uint8_t* __restrict__ valid,
                    float* __restrict__ part_s, int* __restrict__ part_i,
                    int nq, int n, int dim, int k, int n_split, int stages,
                    int slots) {
  using namespace sm90;
  using wd::kBox;
  using wd::kConsumers;
  using wd::kRowBytes;
  using wd::kRows;
  using wd::kWarps;
  constexpr int kQBytes = NQ * 128;                  // a query box, hi or lo
  constexpr int kStageBytes = kRowBytes + 2 * kQBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);    // generic address of base
  const int sp = slots;
  const int nbox = (dim + kBox - 1) / kBox;
  float* ls = reinterpret_cast<float*>(gbase + stages * kStageBytes);
  int* li = reinterpret_cast<int*>(ls + NQ * sp);
  int* cnt = li + NQ * sp;
  float* thr_s = reinterpret_cast<float*>(cnt + NQ);
  int* thr_i = reinterpret_cast<int*>(thr_s + NQ);
  const uint32_t s_bar = (smem_u32(thr_i + NQ) + 7u) & ~7u;
  auto full = [&](int st) { return s_bar + 8u * st; };
  auto empty = [&](int st) { return s_bar + 8u * (stages + st); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q_tiles = (nq + NQ - 1) / NQ;
  const int n_items = n_split * q_tiles;
  const int n_tiles = (n + kRows - 1) / kRows;

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    mbar_fence_init();
  }
  for (int i = tid; i < NQ; i += wd::kThreads) {
    cnt[i] = 0;
    thr_s[i] = CUDART_INF_F;
    thr_i[i] = kPadId;
  }
  __syncthreads();

  if (warp >= kWarps) {
    // ---- producer warpgroup: hands its registers to the consumers; one
    // thread keeps the ring full ------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == kWarps && lane == 0) {
      int it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int split = item / q_tiles, qt = item % q_tiles;
        const int t_begin = split_begin(split, n_tiles, n_split);
        const int t_end = split_begin(split + 1, n_tiles, n_split);
        const float* qbox = qsplit + (size_t)qt * nbox * 2 * NQ * kBox;
        for (int tile = t_begin; tile < t_end; ++tile)
          for (int b = 0; b < nbox; ++b, ++it) {
            const int st = it % stages;
            if (it >= stages) mbar_wait(empty(st), ((it / stages) & 1) ^ 1);
            const uint32_t dst = base + st * kStageBytes;
            mbar_expect_tx(full(st), kStageBytes);
            tma_load_2d(dst, &tm_db, full(st), b * kBox, tile * kRows);
            bulk_load(dst + kRowBytes, qbox + (size_t)b * 2 * NQ * kBox,
                      2 * kQBytes, full(st));
          }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // ---- consumers: warpgroup cw scores rows 64 cw .. 64 cw + 63 of a tile --
    const int cw = warp >> 2;
    const int g = lane >> 2, t4 = lane & 3;
    const int lrow = 64 * cw + 16 * (warp & 3) + g;   // rows lrow, lrow + 8
    // The 12 products of a box go round-robin to kChains accumulator sets, so
    // that a small product does not wait on the one before it.  The sets
    // start afresh every kFold boxes (128 dims), and their sum is then added
    // to `dot` in float32 registers, each add rounded to nearest.  Carried
    // over all 1,344 products of 3,584 dims, the tensor cores' own float32
    // sums drifted by 0.19 in a score of the paper's corpus (the plain
    // version's limit there: 0.109); the drift grows with the sum it is
    // added to, so a fold of 128 dims keeps it near 1/28 of that.
    constexpr int kChains = NQ == 64 ? 2 : NQ == 32 ? 4 : NQ == 16 ? 6 : 12;
    float acc[kChains][NQ / 2];
    float dot[NQ / 2];
#pragma unroll
    for (int c = 0; c < kChains; ++c)     // (each box overwrites them first)
#pragma unroll
      for (int i = 0; i < NQ / 2; ++i) acc[c][i] = 0.f;
    int it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int split = item / q_tiles;
      const int q0 = (item % q_tiles) * NQ;
      const int t_begin = split_begin(split, n_tiles, n_split);
      const int t_end = split_begin(split + 1, n_tiles, n_split);
      const int n_live = min(NQ, nq - q0);
      for (int tile = t_begin; tile < t_end; ++tile) {
#pragma unroll
        for (int i = 0; i < NQ / 2; ++i) dot[i] = 0.f;
        float nrm[2] = {0.f, 0.f};
        // the rows' norms and validity, loaded while the tile is multiplied
        bool ok[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int row = tile * kRows + lrow + 8 * u;
          ok[u] = row < n && (valid == nullptr || valid[row] != 0);
          if (HAS_SQ) nrm[u] = row < n ? sq[row] : 0.f;
        }
        for (int b = 0; b < nbox; ++b, ++it) {
          const int st = it % stages;
          mbar_wait(full(st), (it / stages) & 1);
          const uint32_t s_stage = base + st * kStageBytes;
          const uint8_t* ring = gbase + st * kStageBytes;
          float x[2][8];                  // rows lrow, lrow + 8: dims 8 t4 ..
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float4 f = *reinterpret_cast<const float4*>(
                  ring + swz128(lrow + 8 * u, 4 * (2 * t4 + h)));
              x[u][4 * h] = f.x;
              x[u][4 * h + 1] = f.y;
              x[u][4 * h + 2] = f.z;
              x[u][4 * h + 3] = f.w;
            }
          if (!HAS_SQ)
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int e = 0; e < 8; ++e)
                nrm[u] = fmaf(x[u][e], x[u][e], nrm[u]);
          uint32_t ahi[4][4], alo[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) {  // (row g | g + 8) x (2j | 2j + 1)
              const float v = x[r & 1][2 * j + (r >> 1)];
              const float hi = tf32_round(v);
              ahi[j][r] = __float_as_uint(hi);
              alo[j][r] = __float_as_uint(tf32_round(v - hi));
            }
          // product m = 3 j + p goes to set m % kChains; in the first box of
          // a fold the first product of each set (m < kChains) overwrites it
          const bool fresh = b % wd::kFold == 0;
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t off = s_stage + kRowBytes + 32 * j;
            const uint64_t dhi = desc_sw128(off, 16, 1024);
            const uint64_t dlo = desc_sw128(off + kQBytes, 16, 1024);
            wgmma_tf32<NQ>(acc[(3 * j) % kChains], alo[j], dhi,
                           !fresh || 3 * j >= kChains);
            wgmma_tf32<NQ>(acc[(3 * j + 1) % kChains], ahi[j], dlo,
                           !fresh || 3 * j + 1 >= kChains);
            wgmma_tf32<NQ>(acc[(3 * j + 2) % kChains], ahi[j], dhi,
                           !fresh || 3 * j + 2 >= kChains);
          }
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int c = 0; c < kChains; ++c) fence_regs(acc[c]);
          if (b % wd::kFold == wd::kFold - 1 || b == nbox - 1) {
#pragma unroll
            for (int i = 0; i < NQ / 2; ++i) {
              float s = acc[0][i];
#pragma unroll
              for (int c = 1; c < kChains; ++c) s += acc[c][i];
              dot[i] += s;
            }
          }
          mbar_arrive(empty(st));         // rows and query boxes are read
        }
        if (!HAS_SQ)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            nrm[u] += __shfl_xor_sync(kFull, nrm[u], 1);
            nrm[u] += __shfl_xor_sync(kFull, nrm[u], 2);
          }
        // Offer the tile's scores: D's element i is row g + 8 ((i >> 1) &
        // 1), query 8 (i >> 2) + 2 t4 + (i & 1).  Most tiles have no
        // survivor in a warp, so the test is register arithmetic against
        // each query's threshold (read once a tile: registers are the dim
        // loop's) and one vote; only then do the appends run.  A query's 16
        // scores in a warp sit in the 8 lanes of one t4: the warp takes one
        // slot range per query with survivors (one atomic, from the lowest
        // such lane), and each lane writes its survivors at its rank among
        // them.
        const int row0 = tile * kRows + lrow;
        bool take[2][NQ / 4];
        float sc[2][NQ / 4];
        bool mine = false;
#pragma unroll
        for (int c = 0; c < NQ / 4; ++c)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int qq = 8 * (c >> 1) + 2 * t4 + (c & 1);
            sc[u][c] = nrm[u] - 2.0f * dot[4 * (c >> 1) + 2 * u + (c & 1)];
            take[u][c] = ok[u] && qq < n_live && sc[u][c] < CUDART_INF_F &&
                         cand_less(sc[u][c], row0 + 8 * u, thr_s[qq],
                                   thr_i[qq]);
            mine |= take[u][c];
          }
        bool need = false;
        if (__any_sync(kFull, mine)) {
          const unsigned grp = 0x11111111u << t4;         // lanes of this t4
          const unsigned below = (1u << lane) - 1u;
          unsigned m[2][NQ / 4];
          int at[NQ / 4];
#pragma unroll
          for (int c = 0; c < NQ / 4; ++c) {
            const int qq = 8 * (c >> 1) + 2 * t4 + (c & 1);
            m[0][c] = __ballot_sync(kFull, take[0][c]) & grp;
            m[1][c] = __ballot_sync(kFull, take[1][c]) & grp;
            const unsigned any = m[0][c] | m[1][c];
            at[c] = 0;
            if (any != 0u && lane == __ffs(any) - 1)
              at[c] = atomicAdd(&cnt[qq], __popc(m[0][c]) + __popc(m[1][c]));
          }
#pragma unroll
          for (int c = 0; c < NQ / 4; ++c) {
            const unsigned any = m[0][c] | m[1][c];
            const int qq = 8 * (c >> 1) + 2 * t4 + (c & 1);
            const int b0 =
                __shfl_sync(kFull, at[c], any ? __ffs(any) - 1 : lane);
            const int n0 = __popc(m[0][c]);
            need |= b0 + n0 + __popc(m[1][c]) > sp - kRows;
            if (take[0][c]) {
              const int pos = b0 + __popc(m[0][c] & below);
              ls[qq * sp + pos] = sc[0][c];
              li[qq * sp + pos] = row0;
            }
            if (take[1][c]) {
              const int pos = b0 + n0 + __popc(m[1][c] & below);
              ls[qq * sp + pos] = sc[1][c];
              li[qq * sp + pos] = row0 + 8;
            }
          }
        }
        // when a list could overflow on the next tile, each warp tightens its
        // lists (query qq belongs to consumer warp qq % 8) that hold more
        // than k, all at once, so such stops stay rare
        if (bar_or(1, kConsumers, need)) {
          for (int qq = warp; qq < n_live; qq += kWarps) {
            const int c = cnt[qq];
            if (c > k) {
              const Tight tt = tighten_any(ls + qq * sp, li + qq * sp, c, k,
                                           kRows, sp);
              if (lane == 0) {
                cnt[qq] = tt.cnt;
                thr_s[qq] = tt.thr.s;
                thr_i[qq] = tt.thr.i;
              }
            }
          }
          bar_sync(2, kConsumers);
        }
      }
      // the item's sorted top k of each live query, then empty lists for the
      // next item
      for (int qq = warp; qq < n_live; qq += kWarps) {
        float* s_l = ls + qq * sp;
        int* i_l = li + qq * sp;
        int c = cnt[qq];
        if (c > k) c = tighten_any(s_l, i_l, c, k, kRows, sp).cnt;
        const size_t o = ((size_t)(q0 + qq) * n_split + split) * k;
        emit_any(s_l, i_l, c, k, sp, part_s + o, part_i + o);
      }
      bar_sync(2, kConsumers);
      for (int i = tid; i < NQ; i += kConsumers) {
        cnt[i] = 0;
        thr_s[i] = CUDART_INF_F;
        thr_i[i] = kPadId;
      }
      bar_sync(2, kConsumers);
    }
  }
}

// The arguments of a call, packed by the wrapper into one buffer.
struct WideArgs {
  const float* q;           // (nq, ld_q) float32
  const float* db;          // (n, ld_db) float32 rows
  const float* sq;          // (n,) prefix norms at dim, or null
  const uint8_t* valid;     // (n,) bytes, or null (all valid)
  float* qsplit;            // the pre-pass's boxes (q_tiles, nbox, 2, tile, 32)
  float* part_s;            // (nq, n_split, k) pass-1 lists
  int* part_i;
  float* mid_s;             // (nq, n_groups, k) merged groups (n_groups > 1)
  int* mid_i;
  float* out_s;             // (nq, k)
  int* out_i;
  void* stream;
  long long ld_q, ld_db;
  int nq, n, dim, k;
  int tile_q, slots, stages;  // the wrapper's plan, checked against the table
  int n_split, grid;
  int n_groups;             // pass 2: groups of up to 32 lists per query
};

template <int NQ, bool HAS_SQ>
cudaError_t launch_wide_nt(const WideArgs& a, const CUtensorMap& tm,
                           cudaStream_t st) {
  const size_t smem = wide_smem_bytes(NQ, a.slots, a.stages);
  auto kern = l2_scan_wide_kernel<NQ, HAS_SQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<a.grid, wd::kThreads, smem, st>>>(
      tm, a.qsplit, a.sq, a.valid, a.part_s, a.part_i, a.nq, a.n, a.dim, a.k,
      a.n_split, a.stages, a.slots);
  return cudaGetLastError();
}

template <int NQ>
cudaError_t launch_wide_tile(const WideArgs& a, const CUtensorMap& tm,
                             cudaStream_t st) {
  return a.sq != nullptr ? launch_wide_nt<NQ, true>(a, tm, st)
                         : launch_wide_nt<NQ, false>(a, tm, st);
}

cudaError_t launch_wide(const WideArgs& a, cudaStream_t st) {
  int tile, slots, stages;
  const long long n_tiles = (a.n + wd::kRows - 1) / wd::kRows;
  // TMA: a 16-byte aligned base and row stride, a dim a multiple of 4
  if (a.nq < 1 || a.n < 1 || a.dim < 1 || a.dim % 4 || a.ld_db % 4 ||
      reinterpret_cast<uintptr_t>(a.db) % 16 ||
      reinterpret_cast<uintptr_t>(a.qsplit) % 16 ||
      !wide_plan(a.nq, a.k, &tile, &slots, &stages) || tile != a.tile_q ||
      slots != a.slots || stages != a.stages || a.n_split < 1 ||
      a.n_split > n_tiles || a.grid < 1)
    return cudaErrorInvalidValue;
  const sm90::EncodeTiled enc = sm90::encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  // the rows' [:dim] prefix: a (n, dim) tensor at row stride ld_db, in
  // boxes of 32 dims x 128 rows; dims past `dim`, rows past n read as 0
  CUtensorMap tm;
  const cuuint64_t dims[2] = {(cuuint64_t)a.dim, (cuuint64_t)a.n};
  const cuuint64_t strides[1] = {(cuuint64_t)a.ld_db * 4};
  const cuuint32_t box[2] = {(cuuint32_t)wd::kBox, (cuuint32_t)wd::kRows};
  const cuuint32_t unit[2] = {1, 1};
  if (enc(&tm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a.db),
          dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const int nbox = (a.dim + wd::kBox - 1) / wd::kBox;
  const long long total =
      (long long)((a.nq + tile - 1) / tile) * nbox * tile * wd::kBox;
  const long long blocks = (total + wd::kSplitThreads - 1) / wd::kSplitThreads;
  wide_split_queries<<<(int)(blocks < 4096 ? blocks : 4096),
                       wd::kSplitThreads, 0, st>>>(
      a.q, a.ld_q, a.nq, a.dim, tile, nbox, total, a.qsplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (tile) {
    case 8: return launch_wide_tile<8>(a, tm, st);
    case 16: return launch_wide_tile<16>(a, tm, st);
    case 32: return launch_wide_tile<32>(a, tm, st);
    case 64: return launch_wide_tile<64>(a, tm, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The plan of a call of nq queries at k as this library was built: out =
// (queries a tile, slots a list, ring stages, dynamic shared memory).
int l2_topk_wide_plan(int nq, int k, int* out) {
  int tile, slots, stages;
  if (nq < 1 || k < 1 || !wide_plan(nq, k, &tile, &slots, &stages))
    return (int)cudaErrorInvalidValue;
  out[0] = tile;
  out[1] = slots;
  out[2] = stages;
  out[3] = (int)wide_smem_bytes(tile, slots, stages);
  return 0;
}

int l2_topk_wide_args_size() { return (int)sizeof(WideArgs); }

// Runs the query pre-pass, pass 1 and pass 2 on the arguments packed at
// `args` (a WideArgs).  Returns the first CUDA error of the launches (0 on
// success).
int l2_topk_wide_launch(const void* args) {
  const WideArgs& a = *static_cast<const WideArgs*>(args);
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  cudaError_t err = a.k < 1 || a.k > 1024 ? cudaErrorInvalidValue
                                          : launch_wide(a, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merges(a.part_s, a.part_i, a.mid_s, a.mid_i, a.out_s,
                            a.out_i, a.nq, a.n_split, a.n_groups, a.k, st);
}

// Human-readable name of a CUDA error code returned by the launcher.
const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
