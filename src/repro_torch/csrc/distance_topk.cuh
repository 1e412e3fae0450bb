// Stage-0 fused truncated-L2 scan with top-k, for Hopper (sm_90a).
//
// Replaces the TPU kernel `l2_topk` of the JAX package
// (src/repro/kernels/distance_topk.py): score every stored row against a
// batch of queries over the first `dim` dims and keep the best k per query,
// without writing the (Q, N) score matrix anywhere.
//
// Bound on an H100 SXM: one read of the [:dim] prefix of every row plus its
// prefix norm and validity byte (N * (4*dim + 5) bytes; 1M rows at dim 128
// is 542 MB, 0.16 ms at 3.35 TB/s) against 2*Q*N*dim operations (8.6 GFLOP
// at Q=32: memory-bound).  At the two-tower's stage 0 (Q=512, dim 64, 1M
// rows) the 67 GFLOP lead: 1.0 ms as float32 FMA at 67 TFLOP/s, 0.41 ms as
// the three TF32 products below at 495 TFLOP/s.
//
// Design.  The TPU kernel carries its top-k across a sequential grid; a
// Hopper grid has no order, so the scan has two passes, and pass 1 has two
// kernels (`route` in kernels/distance_topk.py picks one):
//   pass 1, `wgmma` (l2_scan_wgmma_kernel): a GEMM with selection on the
//     tensor cores, for rows TMA can load (16-byte aligned, dim a multiple
//     of 4, at most 256 dims a query tile).  Rows are the M side (64 per
//     consumer warpgroup; three warpgroups, 192-row tiles, up to k = 128,
//     two above, where a list needs more room), queries the N side (a tile
//     of NT = 8, 16 or 32), dims the K side.  One producer warp streams
//     the [:dim] prefix of the block's row range by TMA (32-dim boxes of a
//     tile's rows, 128-byte swizzle, from a 2-d tensor map over (Ncap,
//     ld_db)) into a ring of mbarrier stages.  Precision is
//     split TF32 (3xTF32): a row value is split in registers into hi =
//     tf32(x) and lo = tf32(x - hi), the queries once per block into hi and
//     lo tiles in shared memory, and the product is hi*hi + hi*lo + lo*hi
//     with float32 accumulators (about 2^-21 of each |q_i x_i|, where one
//     TF32 product keeps 2^-11); a box's 12 products go round-robin to
//     several accumulator sets, since a small wgmma is latency, not work.
//     The epilogue of a tile is the FMA kernel's selection: score = sq -
//     2 acc, invalid rows dropped, a threshold test in registers against
//     each query's current k-th best, survivors appended to the query's
//     512-slot list in shared memory (one atomic per warp and query), and
//     the lists tightened by a radix select when one nears full.  That
//     selection, not the products, is most of the kernel's time (PERF.md).
//     Lists of k + one tile of candidates cap the query tile at 32 (32
//     lists of 512 take 128 KB), so a batch of 512 runs 16 query tiles; the
//     grid puts the query tiles of a row range side by side, so the range
//     comes from device memory once and from L2 for the other tiles.
//   pass 1, `fma` (l2_scan_kernel): everything else (a row stride or base
//     TMA cannot take, a dim not a multiple of 4, wider than 256).  The
//     first version of this port: the doc axis is split into contiguous
//     ranges, one block per (range, query tile) and one block per SM.  A
//     block streams 128-row tiles of its range, 64 dims at a time, through a
//     two-stage shared-memory ring filled by cp.async, so the next chunk is
//     in flight while the current one is multiplied.  Each warp owns RQ
//     queries and scores them against the tile's rows (4 per lane) in
//     float32 FMA from swizzled, bank-conflict-free shared-memory reads.
//     Because a warp owns its queries, the top-k selection is warp-local:
//     scores that beat a query's threshold are appended to its 512-slot list
//     with a ballot, and a list near full is tightened by the radix select.
//   Each pass-1 block writes its sorted top-k to a (Q, n_split, k) scratch.
//   pass 2 (l2_merge_kernel): folds each query's n_split lists into the
//     final (Q, k) with the same tie order, a block per (query, group of up
//     to 32 lists) and, when there is more than one group, a second launch
//     over the groups' lists, so a small batch spreads over the SMs instead
//     of one block per query.  A warp per list reads it from the front and
//     stops at the first entry that cannot beat the current k-th best (the
//     lists are sorted), so most lists cost one 32-entry read.
//   Large k (256 < k <= 1024, the paper's k0 sweep): the same two pass-1
//     kernels with lists of `list_slots(k)` = 2 * next_pow2(k) slots (1,024
//     or 2,048) in shared memory, so a block holds fewer queries (the
//     wrapper picks the tile); such a list is too long for the register
//     networks, so it is tightened by the same radix select run over shared
//     memory (`tighten_big`) and sorted there by a warp's bitonic network
//     (`sort_list_big`).  Pass 2 folds fewer lists a round (`merge_warps`:
//     32 up to k = 256, 16 at 512, 8 at 1,024), so its running list plus
//     1.5 rounds of lists stays at 16,384 slots.  Calls at k <= 256 compile
//     and run exactly as before (BIG = false, lists of kSlots).
//   bf16 rows and queries (the staged index's stage-0 block; the TPU
//     kernel's bf16 inputs, float32 accumulation): both pass-1 kernels have
//     a bf16 instantiation (T = bf16).  `wgmma` streams 64-dim boxes of
//     bf16 rows by TMA and issues one m64nNk16 bf16 product a k16 step
//     from the rows as loaded (no hi / lo split: a product of two bf16
//     values is exact in float32), against one bf16 query tile; `route`
//     sends it rows with a 16-byte aligned base, a row stride that is a
//     multiple of 8 and a dim that is a multiple of 16.  `fma` widens the
//     rows and queries to float32 on their way into shared memory and runs
//     the float32 kernel's arithmetic.  Both read half the bytes of the
//     float32 routes; the products are exact, so a score differs from the
//     plain version's only by the order of its float32 sums.
// Ties order by (score, row index); slots with no finite score return -1.
// The result does not depend on the number of splits or groups.

// The body of both libraries: distance_topk.cu instantiates it for
// float32 rows (L2_ELEM float), distance_topk_bf16.cu for bf16 rows, so
// the two sets of templates compile side by side.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "sm90.cuh"

#ifndef L2_ELEM
#error "define L2_ELEM (float or __nv_bfloat16) before including distance_topk.cuh"
#endif

namespace {

// A candidate is a (score, id) pair ordered lexicographically: lower score
// first, and at equal scores the lower id — the tie rule of the plain
// version (a stable sort by score over rows listed in id order).  Padding
// slots carry kPadId, which ranks after every real id at equal score.
constexpr int kPadId = 0x7fffffff;

__device__ __forceinline__ bool cand_less(float as, int ai, float bs, int bi) {
  return as < bs || (as == bs && ai < bi);
}

// Sorts `nlists` arrays of `sp` (a power of two) candidates each, stored
// back to back in (s, id), ascending.  Every thread of the block calls it;
// it synchronises the block between the bitonic stages and on return.
__device__ void bitonic_sort_lists(float* s, int* id, int nlists, int sp) {
  const int log_sp = __ffs(sp) - 1;
  const int half = sp >> 1;
  const int pairs = nlists * half;
  for (int size = 2; size <= sp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < pairs; t += blockDim.x) {
        const int list = t >> (log_sp - 1);
        const int j = t & (half - 1);
        const int lo = ((j & ~(stride - 1)) << 1) | (j & (stride - 1));
        const int hi = lo + stride;
        const bool ascending = (lo & size) == 0;
        float* ls = s + (list << log_sp);
        int* li = id + (list << log_sp);
        const float s_lo = ls[lo], s_hi = ls[hi];
        const int i_lo = li[lo], i_hi = li[hi];
        const bool swap = ascending ? cand_less(s_hi, i_hi, s_lo, i_lo)
                                    : cand_less(s_lo, i_lo, s_hi, i_hi);
        if (swap) {
          ls[lo] = s_hi; ls[hi] = s_lo;
          li[lo] = i_hi; li[hi] = i_lo;
        }
      }
      __syncthreads();
    }
  }
}

// Folds a list's pending buffer into its running top-k.
//
// The list holds its sorted top-kp in [0, kp) and `*cnt` pending candidates
// in [kp, kp + *cnt); the rest of its `sp` slots are stale.  After the call
// [0, kp) is the sorted top-kp of both, *cnt is 0 and (*thr_s, *thr_i) is
// the k-th best candidate: a new candidate enters the buffer only if it
// ranks before it.  Only the next power of two above kp + *cnt is sorted.
__device__ void merge_pending(float* s, int* id, int* cnt, float* thr_s,
                              int* thr_i, int sp, int kp, int k) {
  const int n = kp + *cnt;
  int n2 = kp;
  while (n2 < n) n2 <<= 1;
  n2 = min(n2, sp);
  for (int t = n + threadIdx.x; t < n2; t += blockDim.x) {
    s[t] = CUDART_INF_F;
    id[t] = kPadId;
  }
  __syncthreads();
  bitonic_sort_lists(s, id, 1, n2);
  if (threadIdx.x == 0) {
    *cnt = 0;
    *thr_s = s[k - 1];
    *thr_i = id[k - 1];
  }
  __syncthreads();
}

// Resets every list to empty: (+inf, pad) slots, no pending candidates.
__device__ void init_lists(float* s, int* id, int* cnt, float* thr_s,
                           int* thr_i, int nlists, int sp) {
  for (int t = threadIdx.x; t < nlists * sp; t += blockDim.x) {
    s[t] = CUDART_INF_F;
    id[t] = kPadId;
  }
  for (int l = threadIdx.x; l < nlists; l += blockDim.x) {
    cnt[l] = 0;
    thr_s[l] = CUDART_INF_F;
    thr_i[l] = kPadId;
  }
  __syncthreads();
}

constexpr int kThreads = 256;
constexpr int kTileN = 128;                // rows per tile: 4 per lane
constexpr int kRowsPerLane = kTileN / 32;
constexpr int kChunkD = 64;                // dims per pipeline step
constexpr int kPieces = kChunkD / 4;       // 16-byte pieces per row chunk
constexpr int kStage = kTileN * kChunkD;   // floats per ring stage (32 KB)
constexpr int kSlots = 512;                // pass-1 list: candidates per query
constexpr int kMergeThreads = 1024;        // pass 2: one warp per list
constexpr int kMergeWarps = kMergeThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Lists a pass-2 round folds (one a warp): all 32 warps up to kp = 256,
// fewer above, so that a round's lists fit beside the running list.
__host__ __device__ inline int merge_warps(int kp) {
  return kp <= 256 ? kMergeWarps : kMergeWarps * 256 / kp;
}

// Slots of the pass-2 list: the running top-kp plus room for 1.5 rounds
// of w lists of up to kp entries each (16,384 for kp >= 256 at
// w = merge_warps(kp)).
__host__ __device__ inline int merge_slots(int kp, int w) {
  return next_pow2(kp + w * kp + w * kp / 2);
}

// Slots of a pass-1 list at k: kSlots up to k = 256, else twice the next
// power of two above k, so a tightened list has room for many tiles.
__host__ __device__ inline int list_slots(int k) {
  return k <= 256 ? kSlots : 2 * next_pow2(k);
}

// Pass-1 shared memory: two ring stages of rows, the query chunk (one copy
// when dim fits one chunk, else one per stage) and QT lists of `slots`.
__host__ __device__ inline size_t scan_smem_bytes(int qt, int dim,
                                                  int slots) {
  const int q_copies = dim <= kChunkD ? 1 : 2;
  return sizeof(float) * (2 * (size_t)kStage + (size_t)q_copies * qt * kChunkD)
       + (sizeof(float) + sizeof(int)) * (size_t)qt * slots;
}

// Float offset of 16-byte piece `p` of tile row `row`: pieces are XOR-
// swizzled by the row's low 3 bits, so the 8 lanes of each quarter-warp,
// reading 8 consecutive rows at one piece, hit 8 distinct bank groups.
__device__ __forceinline__ int swz(int row, int p) {
  return row * kChunkD + ((p ^ (row & 7)) << 2);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(full ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

typedef __nv_bfloat16 bf16;

// The two bf16 values of a 32-bit word (the lower address in the low half)
// widened to float32: a bf16 is the top 16 bits of its float32.
__device__ __forceinline__ float2 widen2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// Eight widened bf16 values (a 16-byte word) into two float4 at dst0, dst1.
__device__ __forceinline__ void store_widened(float* dst0, float* dst1,
                                              uint4 w) {
  const float2 a = widen2(w.x), b = widen2(w.y);
  const float2 c = widen2(w.z), d = widen2(w.w);
  *reinterpret_cast<float4*>(dst0) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(dst1) = make_float4(c.x, c.y, d.x, d.y);
}

// Starts the copy of rows [row0, row0 + kTileN) x dims [d0, d0 + kChunkD)
// into a ring stage; rows past n and dims past dim are zero-filled.  With
// VEC each warp copies one row's 512 bytes per instruction.
template <bool VEC>
__device__ void issue_rows(float* stage, const float* __restrict__ db, int n,
                           int ld_db, int dim, int row0, int d0) {
  if (VEC) {
#pragma unroll
    for (int m = 0; m < kTileN * kPieces / kThreads; ++m) {
      const int f = threadIdx.x + kThreads * m;
      const int row = f / kPieces, p = f % kPieces;
      const int gr = row0 + row, gd = d0 + 4 * p;
      const bool ok = gr < n && gd < dim;
      cp_async16(stage + swz(row, p), ok ? db + (size_t)gr * ld_db + gd : db, ok);
    }
  } else {
    for (int m = 0; m < kTileN * kChunkD / kThreads; ++m) {
      const int f = threadIdx.x + kThreads * m;
      const int row = f / kChunkD, c = f % kChunkD;
      const int gr = row0 + row, gd = d0 + c;
      const bool ok = gr < n && gd < dim;
      cp_async4(stage + swz(row, c >> 2) + (c & 3),
                ok ? db + (size_t)gr * ld_db + gd : db, ok);
    }
  }
}

// Starts the copy of queries [q0, q0 + qt) x dims [d0, d0 + kChunkD) into
// a (qt, kChunkD) row-major buffer, zero-filled past nq and dim.
template <bool VEC>
__device__ void issue_queries(float* qs, const float* __restrict__ q, int nq,
                              int ld_q, int dim, int q0, int qt, int d0) {
  if (VEC) {
    for (int t = threadIdx.x; t < qt * kPieces; t += kThreads) {
      const int qq = t / kPieces, p = t % kPieces;
      const int gq = q0 + qq, gd = d0 + 4 * p;
      const bool ok = gq < nq && gd < dim;
      cp_async16(qs + qq * kChunkD + 4 * p,
                 ok ? q + (size_t)gq * ld_q + gd : q, ok);
    }
  } else {
    for (int t = threadIdx.x; t < qt * kChunkD; t += kThreads) {
      const int qq = t / kChunkD, c = t % kChunkD;
      const int gq = q0 + qq, gd = d0 + c;
      const bool ok = gq < nq && gd < dim;
      cp_async4(qs + qq * kChunkD + c, ok ? q + (size_t)gq * ld_q + gd : q, ok);
    }
  }
}

// The bf16 rows of `issue_rows`, widened to float32 on their way into the
// stage, whose layout is the float32 route's: plain loads (cp.async copies
// bytes unchanged), so the copy is done when the call returns.  With VEC
// each thread loads 16-byte words (8 dims) of a row.
template <bool VEC>
__device__ void issue_rows(float* stage, const bf16* __restrict__ db, int n,
                           int ld_db, int dim, int row0, int d0) {
  if (VEC) {
    constexpr int kWords = kChunkD / 8;        // 16-byte words of a row chunk
    constexpr int M = kTileN * kWords / kThreads;
    uint4 w[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int f = threadIdx.x + kThreads * m;
      const int gr = row0 + f / kWords, gd = d0 + 8 * (f % kWords);
      w[m] = gr < n && gd < dim
                 ? *reinterpret_cast<const uint4*>(db + (size_t)gr * ld_db + gd)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int f = threadIdx.x + kThreads * m;
      const int row = f / kWords, p = f % kWords;
      store_widened(stage + swz(row, 2 * p), stage + swz(row, 2 * p + 1), w[m]);
    }
  } else {
    for (int m = 0; m < kTileN * kChunkD / kThreads; ++m) {
      const int f = threadIdx.x + kThreads * m;
      const int row = f / kChunkD, c = f % kChunkD;
      const int gr = row0 + row, gd = d0 + c;
      stage[swz(row, c >> 2) + (c & 3)] =
          gr < n && gd < dim ? __bfloat162float(db[(size_t)gr * ld_db + gd])
                             : 0.f;
    }
  }
}

// The bf16 queries of `issue_queries`, widened as `issue_rows` widens rows.
template <bool VEC>
__device__ void issue_queries(float* qs, const bf16* __restrict__ q, int nq,
                              int ld_q, int dim, int q0, int qt, int d0) {
  if (VEC) {
    constexpr int kWords = kChunkD / 8;
    for (int t = threadIdx.x; t < qt * kWords; t += kThreads) {
      const int qq = t / kWords, p = t % kWords;
      const int gq = q0 + qq, gd = d0 + 8 * p;
      const uint4 w = gq < nq && gd < dim
          ? *reinterpret_cast<const uint4*>(q + (size_t)gq * ld_q + gd)
          : make_uint4(0u, 0u, 0u, 0u);
      store_widened(qs + qq * kChunkD + 8 * p, qs + qq * kChunkD + 8 * p + 4, w);
    }
  } else {
    for (int t = threadIdx.x; t < qt * kChunkD; t += kThreads) {
      const int qq = t / kChunkD, c = t % kChunkD;
      const int gq = q0 + qq, gd = d0 + c;
      qs[qq * kChunkD + c] = gq < nq && gd < dim
          ? __bfloat162float(q[(size_t)gq * ld_q + gd]) : 0.f;
    }
  }
}

// Orders one register pair: ascending (a before b) when `asc`, else
// descending, by (score, id).
__device__ __forceinline__ void order_pair(float& as, int& ai, float& bs,
                                           int& bi, bool asc) {
  const bool swap = asc ? cand_less(bs, bi, as, ai) : cand_less(as, ai, bs, bi);
  if (swap) {
    const float t = as; as = bs; bs = t;
    const int u = ai; ai = bi; bi = u;
  }
}

struct Cand {
  float s;
  int i;
};

// One stage of a bitonic network over kSlots elements held in registers:
// element e = i*32 + lane sits in lane's register i.  SIZE and STRIDE are
// template arguments so every register index is a compile-time constant
// (a runtime index would move the arrays to local memory).
template <int E, int SIZE, int STRIDE>
__device__ __forceinline__ void bitonic_stage(float (&v)[E], int (&w)[E],
                                              int lane) {
  if constexpr (STRIDE >= 32) {              // pairs within a lane
    constexpr int SI = STRIDE / 32;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if ((i & SI) == 0)
        order_pair(v[i], w[i], v[i | SI], w[i | SI],
                   ((i * 32 + lane) & SIZE) == 0);
    }
  } else {                                   // pairs across lanes
    const bool lower = (lane & STRIDE) == 0;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float os = __shfl_xor_sync(kFull, v[i], STRIDE);
      const int oi = __shfl_xor_sync(kFull, w[i], STRIDE);
      const bool keep_min = lower == (((i * 32 + lane) & SIZE) == 0);
      const bool other_first = cand_less(os, oi, v[i], w[i]);
      if (keep_min ? other_first : !other_first) {
        v[i] = os;
        w[i] = oi;
      }
    }
  }
  if constexpr (STRIDE > 1) bitonic_stage<E, SIZE, STRIDE / 2>(v, w, lane);
}

template <int E, int SIZE>
__device__ __forceinline__ void bitonic_sort(float (&v)[E], int (&w)[E],
                                             int lane) {
  bitonic_stage<E, SIZE, SIZE / 2>(v, w, lane);
  if constexpr (SIZE < 32 * E) bitonic_sort<E, SIZE * 2>(v, w, lane);
}

// Loads a list's cnt entries into registers (element e = i*32 + lane in
// lane's register i), padding the other slots with (+inf, pad).
template <int E>
__device__ __forceinline__ void load_list(const float* s, const int* id,
                                          int cnt, int lane, float (&v)[E],
                                          int (&w)[E]) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = i * 32 + lane;
    v[i] = e < cnt ? s[e] : CUDART_INF_F;
    w[i] = e < cnt ? id[e] : kPadId;
  }
}

// Sorts a list's cnt entries in place over all kSlots slots ((+inf, pad)
// past cnt).  The one copy of the 512-element network.
__device__ __noinline__ void sort_list(float* s, int* id, int cnt) {
  constexpr int E = kSlots / 32;
  const int lane = threadIdx.x & 31;
  float v[E];
  int w[E];
  load_list<E>(s, id, cnt, lane, v, w);
  bitonic_sort<E, 2>(v, w, lane);
#pragma unroll
  for (int i = 0; i < E; ++i) {
    s[i * 32 + lane] = v[i];
    id[i * 32 + lane] = w[i];
  }
  __syncwarp();
}

// Float bits mapped to an unsigned key with the same order, and back.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

struct Tight {
  int cnt;        // entries left in the list
  Cand thr;       // a candidate enters only if it ranks before this
};

// Shrinks a list of cnt > k candidates to those that can still make the
// top-k, leaving `room` free slots (a tile's rows), and returns the tighter
// threshold.  Called by the whole owning warp
// with warp-uniform arguments.  A radix select over the score bits (one
// warp-wide count a bit) finds a key prefix T covering the k-th smallest
// score; the list keeps every entry whose key is <= T (at least k, ties
// included) and the threshold admits them, so nothing of the top-k is ever
// dropped.  The top 16 bits usually suffice (the bucket holds the k-th
// score and a few neighbours), which halves the select; the low 16 bits
// are resolved only when the bucket leaves too little room.  No sort: the
// select is a few hundred instructions, far cheaper than a bitonic fold of
// the list.  Should ties at the k-th score leave the list too full for the
// next tile, an exact sort keeps precisely the top-k instead.
__device__ __noinline__ Tight tighten(float* s, int* id, int cnt, int k,
                                      int room) {
  constexpr int E = kSlots / 32;
  const int lane = threadIdx.x & 31;
  float v[E];
  int w[E];
  load_list<E>(s, id, cnt, lane, v, w);
  unsigned key[E];
#pragma unroll
  for (int i = 0; i < E; ++i)
    key[i] = i * 32 + lane < cnt ? order_key(v[i]) : 0xffffffffu;
  unsigned prefix = 0;
  int remaining = k;
  unsigned top = 0xffffffffu;                  // keys <= top are kept
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned hi = bit == 31 ? 0u : (0xffffffffu << (bit + 1));
    int c = 0;
#pragma unroll
    for (int i = 0; i < E; ++i)
      c += (key[i] & hi) == prefix && ((key[i] >> bit) & 1u) == 0;
    c = __reduce_add_sync(kFull, c);
    if (c < remaining) {
      prefix |= 1u << bit;
      remaining -= c;
    }
    top = prefix | ((1u << bit) - 1u);
    if (bit == 16) {                           // is the 16-bit bucket enough?
      int n = 0;
#pragma unroll
      for (int i = 0; i < E; ++i) n += key[i] <= top;
      if (__reduce_add_sync(kFull, n) <= kSlots - room) break;
    }
  }
  __syncwarp();
  int kept = 0;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const bool keep = key[i] <= top && i * 32 + lane < cnt;
    const unsigned m = __ballot_sync(kFull, keep);
    if (keep) {
      const int pos = kept + __popc(m & ((1u << lane) - 1u));
      s[pos] = v[i];
      id[pos] = w[i];
    }
    kept += __popc(m);
  }
  __syncwarp();
  if (kept <= kSlots - room) return Tight{kept, Cand{key_float(top), kPadId}};
  // a flood of exact ties at T: keep exactly the top-k, in order
  sort_list(s, id, kept);
  return Tight{k, Cand{s[k - 1], id[k - 1]}};
}

// Sorts a list's cnt entries and writes its first k as the block's
// partial result ((+inf, -1) past the end).  Small lists (the usual case
// after the last tighten) sort in a 128-slot register network.
__device__ __noinline__ void emit_sorted(float* s, int* id, int cnt, int k,
                                         float* out_s, int* out_i) {
  const int lane = threadIdx.x & 31;
  if (max(cnt, k) <= 128) {
    float v[4];
    int w[4];
    load_list<4>(s, id, cnt, lane, v, w);
    bitonic_sort<4, 2>(v, w, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = i * 32 + lane;
      if (e < k) {
        out_s[e] = v[i];
        out_i[e] = v[i] < CUDART_INF_F ? w[i] : -1;
      }
    }
    return;
  }
  sort_list(s, id, cnt);
  for (int e = lane; e < k; e += 32) {
    out_s[e] = s[e];
    out_i[e] = s[e] < CUDART_INF_F ? id[e] : -1;
  }
}

// The large-k lists (list_slots(k) > kSlots): the same operations on lists
// too long for registers, run by the owning warp over shared memory.

// Sorts a list's cnt entries in place over the next power of two (at least
// 32) slots, padded with (+inf, pad); a warp's bitonic network.
__device__ __noinline__ void sort_list_big(float* s, int* id, int cnt) {
  const int lane = threadIdx.x & 31;
  int n2 = 32;
  while (n2 < cnt) n2 <<= 1;
  for (int t = cnt + lane; t < n2; t += 32) {
    s[t] = CUDART_INF_F;
    id[t] = kPadId;
  }
  __syncwarp();
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < n2 / 2; t += 32) {
        const int lo = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const int hi = lo + stride;
        const float s_lo = s[lo], s_hi = s[hi];
        const int i_lo = id[lo], i_hi = id[hi];
        const bool swap = (lo & size) == 0 ? cand_less(s_hi, i_hi, s_lo, i_lo)
                                           : cand_less(s_lo, i_lo, s_hi, i_hi);
        if (swap) {
          s[lo] = s_hi; s[hi] = s_lo;
          id[lo] = i_hi; id[hi] = i_lo;
        }
      }
      __syncwarp();
    }
  }
}

// `tighten` for a list of `sp` slots in shared memory: the scores become
// order keys in place, the radix select counts over shared memory, and the
// kept entries are compacted to the front (as scores again).
__device__ __noinline__ Tight tighten_big(float* s, int* id, int cnt, int k,
                                          int room, int sp) {
  const int lane = threadIdx.x & 31;
  unsigned* key = reinterpret_cast<unsigned*>(s);
  for (int e = lane; e < cnt; e += 32) key[e] = order_key(s[e]);
  __syncwarp();
  unsigned prefix = 0;
  int remaining = k;
  unsigned top = 0xffffffffu;                  // keys <= top are kept
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned hi = bit == 31 ? 0u : (0xffffffffu << (bit + 1));
    int c = 0;
    for (int e = lane; e < cnt; e += 32) {
      const unsigned kk = key[e];
      c += (kk & hi) == prefix && ((kk >> bit) & 1u) == 0;
    }
    c = __reduce_add_sync(kFull, c);
    if (c < remaining) {
      prefix |= 1u << bit;
      remaining -= c;
    }
    top = prefix | ((1u << bit) - 1u);
    if (bit == 16) {                           // is the 16-bit bucket enough?
      int n = 0;
      for (int e = lane; e < cnt; e += 32) n += key[e] <= top;
      if (__reduce_add_sync(kFull, n) <= sp - room) break;
    }
  }
  // compact in place: an entry moves only to a slot at or before its own,
  // and a chunk is read into registers (the ballot waits for every lane's
  // read) before any lane writes into it
  int kept = 0;
  for (int e0 = 0; e0 < cnt; e0 += 32) {
    const int e = e0 + lane;
    const unsigned kk = e < cnt ? key[e] : 0xffffffffu;
    const int ii = e < cnt ? id[e] : kPadId;
    const bool keep = e < cnt && kk <= top;
    const unsigned m = __ballot_sync(kFull, keep);
    if (keep) {
      const int pos = kept + __popc(m & ((1u << lane) - 1u));
      s[pos] = key_float(kk);
      id[pos] = ii;
    }
    kept += __popc(m);
    __syncwarp();
  }
  if (kept <= sp - room) return Tight{kept, Cand{key_float(top), kPadId}};
  // a flood of exact ties at T: keep exactly the top-k, in order
  sort_list_big(s, id, kept);
  return Tight{k, Cand{s[k - 1], id[k - 1]}};
}

// `emit_sorted` for a large-k list: sorted in shared memory, the first k
// written, (+inf, -1) past cnt.
__device__ __noinline__ void emit_sorted_big(float* s, int* id, int cnt,
                                             int k, float* out_s,
                                             int* out_i) {
  const int lane = threadIdx.x & 31;
  sort_list_big(s, id, cnt);
  for (int e = lane; e < k; e += 32) {
    const float v = e < cnt ? s[e] : CUDART_INF_F;
    out_s[e] = v;
    out_i[e] = v < CUDART_INF_F ? id[e] : -1;
  }
  __syncwarp();
}

// A list's tighten and emit, by list size: the register versions for
// lists of kSlots, the shared-memory versions above.
template <bool BIG>
__device__ __forceinline__ Tight tighten_list(float* s, int* id, int cnt,
                                              int k, int room, int sp) {
  if constexpr (BIG) return tighten_big(s, id, cnt, k, room, sp);
  else return tighten(s, id, cnt, k, room);
}

template <bool BIG>
__device__ __forceinline__ void emit_list(float* s, int* id, int cnt, int k,
                                          float* out_s, int* out_i) {
  if constexpr (BIG) emit_sorted_big(s, id, cnt, k, out_s, out_i);
  else emit_sorted(s, id, cnt, k, out_s, out_i);
}

// Pass 1.  grid = (n_split, ceil(nq / QT)), block = kThreads, one block per
// SM.  Warp w owns queries w*RQ .. w*RQ+RQ-1 of the tile and their lists
// (of kSlots, or of `slots` when BIG).  T is float or bf16; bf16 rows and
// queries are widened to float32 in shared memory, so the products (of two
// bf16 values, exact in float32) and the sums are the float32 route's.
template <int RQ, bool VEC, bool HAS_SQ, bool BIG, typename T>
__global__ void __launch_bounds__(kThreads, 1)
l2_scan_kernel(const T* __restrict__ q, const T* __restrict__ db,
               const float* __restrict__ sq, const uint8_t* __restrict__ valid,
               float* __restrict__ part_s, int* __restrict__ part_i,
               int nq, int n, int ld_q, int ld_db, int dim, int k,
               int tiles_per_split, int slots) {
  constexpr int QT = 8 * RQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = BIG ? slots : kSlots;
  const int n_dchunks = (dim + kChunkD - 1) / kChunkD;
  const bool q_once = n_dchunks == 1;
  float* ring = reinterpret_cast<float*>(smem_raw);        // [2][kStage]
  float* qs = ring + 2 * kStage;                           // [1|2][QT][kChunkD]
  float* ls = qs + (q_once ? 1 : 2) * QT * kChunkD;        // [QT][sp]
  int* li = reinterpret_cast<int*>(ls + QT * sp);          // [QT][sp]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int split = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const int n_tiles = (n + kTileN - 1) / kTileN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int steps = max(t_end - t_begin, 0) * n_dchunks;
  // this warp's real queries (the rest of the tile is padding)
  const int n_live = max(0, min(RQ, nq - q0 - warp * RQ));

  // Each live query's list: cnt candidates in [0, cnt), unordered; a
  // score enters only if it ranks before (thr_s, thr_i).
  int cnt[RQ];
  float thr_s[RQ];
  int thr_i[RQ];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    cnt[r] = 0;
    thr_s[r] = CUDART_INF_F;
    thr_i[r] = kPadId;
  }

  if (q_once) issue_queries<VEC>(qs, q, nq, ld_q, dim, q0, QT, 0);
  for (int st = 0; st < 2; ++st) {
    if (st < steps) {
      const int tile = t_begin + st / n_dchunks, dc = st % n_dchunks;
      issue_rows<VEC>(ring + st * kStage, db, n, ld_db, dim, tile * kTileN,
                      dc * kChunkD);
      if (!q_once)
        issue_queries<VEC>(qs + st * QT * kChunkD, q, nq, ld_q, dim, q0, QT,
                           dc * kChunkD);
    }
    cp_commit();
  }

  float acc[RQ][kRowsPerLane];
  float nrm[kRowsPerLane];
  float row_sq[kRowsPerLane];
  bool row_ok[kRowsPerLane];

  for (int step = 0; step < steps; ++step) {
    const int tile = t_begin + step / n_dchunks;
    const int dc = step % n_dchunks;
    const int row0 = tile * kTileN;
    if (dc == 0) {
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j) acc[r][j] = 0.f;
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) {
        nrm[j] = 0.f;
        const int row = row0 + lane + 32 * j;
        row_ok[j] = row < n && (valid == nullptr || valid[row] != 0);
        row_sq[j] = (HAS_SQ && row < n) ? sq[row] : 0.f;
      }
    }
    cp_wait_one();                         // this thread's copies of `step`
    __syncthreads();                       // ... and everyone else's
    const float* B = ring + (step & 1) * kStage;
    const float* Q = qs + (q_once ? 0 : (step & 1) * QT * kChunkD)
                   + warp * RQ * kChunkD;
    if (n_live > 0) {
#pragma unroll 4
      for (int p = 0; p < kPieces; ++p) {
        float4 x[kRowsPerLane];
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j)
          x[j] = *reinterpret_cast<const float4*>(B + swz(lane + 32 * j, p));
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(Q + r * kChunkD + 4 * p);
#pragma unroll
          for (int j = 0; j < kRowsPerLane; ++j) {
            acc[r][j] = fmaf(a.x, x[j].x, acc[r][j]);
            acc[r][j] = fmaf(a.y, x[j].y, acc[r][j]);
            acc[r][j] = fmaf(a.z, x[j].z, acc[r][j]);
            acc[r][j] = fmaf(a.w, x[j].w, acc[r][j]);
          }
        }
        if (!HAS_SQ) {
#pragma unroll
          for (int j = 0; j < kRowsPerLane; ++j) {
            nrm[j] = fmaf(x[j].x, x[j].x, nrm[j]);
            nrm[j] = fmaf(x[j].y, x[j].y, nrm[j]);
            nrm[j] = fmaf(x[j].z, x[j].z, nrm[j]);
            nrm[j] = fmaf(x[j].w, x[j].w, nrm[j]);
          }
        }
      }
    }
    // Offer the tile's scores to this warp's lists; when any list of the
    // block nears full, every warp tightens all its lists at once (after
    // the next copy is issued), so the work overlaps the loads instead of
    // stalling the block one list at a time.
    bool need = false;
    if (dc == n_dchunks - 1) {
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        if (r >= n_live) continue;
        float* s_l = ls + (warp * RQ + r) * sp;
        int* i_l = li + (warp * RQ + r) * sp;
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j) {
          const int row = row0 + lane + 32 * j;
          const float sc = (HAS_SQ ? row_sq[j] : nrm[j]) - 2.0f * acc[r][j];
          const bool take = row_ok[j] && sc < CUDART_INF_F
                            && cand_less(sc, row, thr_s[r], thr_i[r]);
          const unsigned m = __ballot_sync(kFull, take);
          if (take) {
            const int pos = cnt[r] + __popc(m & ((1u << lane) - 1u));
            s_l[pos] = sc;
            i_l[pos] = row;
          }
          cnt[r] += __popc(m);
        }
        need |= cnt[r] > sp - kTileN;
      }
    }
    // stage (step & 1) is free again; tighten if any list must
    const bool tight = __syncthreads_or(need);
    {
      const int nx = step + 2;
      if (nx < steps) {
        const int ntile = t_begin + nx / n_dchunks, ndc = nx % n_dchunks;
        issue_rows<VEC>(ring + (nx & 1) * kStage, db, n, ld_db, dim,
                        ntile * kTileN, ndc * kChunkD);
        if (!q_once)
          issue_queries<VEC>(qs + (nx & 1) * QT * kChunkD, q, nq, ld_q, dim,
                             q0, QT, ndc * kChunkD);
      }
      cp_commit();
    }
    if (tight) {
      __syncwarp();
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        if (r < n_live && cnt[r] > k) {
          const Tight t = tighten_list<BIG>(ls + (warp * RQ + r) * sp,
                                            li + (warp * RQ + r) * sp, cnt[r],
                                            k, kTileN, sp);
          cnt[r] = t.cnt;
          thr_s[r] = t.thr.s;
          thr_i[r] = t.thr.i;
        }
      }
    }
  }
  cp_wait_all();

  const int n_split = gridDim.x;
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    if (r >= n_live) continue;
    float* s_l = ls + (warp * RQ + r) * sp;
    int* i_l = li + (warp * RQ + r) * sp;
    if (cnt[r] > k)
      cnt[r] = tighten_list<BIG>(s_l, i_l, cnt[r], k, kTileN, sp).cnt;
    const size_t o = ((size_t)(q0 + warp * RQ + r) * n_split + split) * k;
    emit_list<BIG>(s_l, i_l, cnt[r], k, part_s + o, part_i + o);
  }
}

// Pass 1 on the tensor cores.  grid = (ceil(nq / NT), n_split): the query
// tiles of one row range are neighbours in launch order, so they stream the
// range at the same time and all but the first read it from L2.  block =
// two consumer warpgroups (warps 0-7) and one producer warp (warp 8).
namespace wg {
constexpr int kBoxBytes = 128;             // a box row: 128 swizzled bytes,
constexpr int kBox = kBoxBytes / 4;        // 32 float32 dims (64 bf16)
constexpr int kMaxStages = 8;
// rows of a tile (64 a consumer warpgroup), threads of a block
__host__ __device__ constexpr int rows(int wgs) { return 64 * wgs; }
__host__ __device__ constexpr int threads(int wgs) { return 128 * wgs + 32; }
}  // namespace wg

// Dynamic shared memory of a tensor-core block of `wgs` consumer
// warpgroups: the row ring, the query tiles (hi and lo for float32, one
// for bf16), NT lists of `slots`, their counts and thresholds, barriers.
__host__ __device__ inline size_t wgmma_smem_bytes(int nt, int dim,
                                                   int stages, int wgs,
                                                   int slots, bool bf16) {
  const int per_box = bf16 ? 2 * wg::kBox : wg::kBox;
  const size_t nbox = (dim + per_box - 1) / per_box;
  return 1024 + (size_t)stages * wg::rows(wgs) * 128 +
         (bf16 ? 1 : 2) * nbox * nt * 128 + (size_t)nt * slots * 8 +
         (size_t)nt * 12 + 8 + (size_t)stages * 16;
}

// Byte offset of element (row, k) of a tile of 128-byte rows under the
// 128-byte swizzle (16-byte chunks permuted by the row's low 3 bits).
__device__ __forceinline__ int swz128(int row, int kk) {
  return row * 128 + (((kk >> 2) ^ (row & 7)) << 4) + (kk & 3) * 4;
}

// The logical k (within a 32-dim box) that holds physical dim kp.  A
// consumer thread reads dims 8t .. 8t + 7 of its rows as two 16-byte words
// (t = lane % 4: conflict-free under the swizzle) and feeds dims 8t + 2j
// and 8t + 2j + 1 to k-step j as A's columns t and t + 4; the query tiles
// are stored with the same permutation, so the sum over k is unchanged.
__device__ __forceinline__ int logical_k(int kp) {
  return 8 * ((kp & 7) >> 1) + (kp >> 3) + 4 * (kp & 1);
}

// The bf16 route's: a box is 64 dims, and the same two 16-byte words of a
// row give a thread dims 16t .. 16t + 15; k16-step j takes dims 16t + 4j,
// 16t + 4j + 1 as A's columns 2t, 2t + 1 and dims 16t + 4j + 2, + 3 as
// columns 2t + 8, 2t + 9 (the bf16 fragment's pairs).
__device__ __forceinline__ int logical_k16(int kp) {
  const int e = kp & 3;
  return 16 * ((kp >> 2) & 3) + 2 * (kp >> 4) + (e & 1) + 8 * (e >> 1);
}

// Byte offset of bf16 element (row, k) of a tile of 128-byte rows under
// the 128-byte swizzle.
__device__ __forceinline__ int swz128_16(int row, int kk) {
  return row * 128 + (((kk >> 3) ^ (row & 7)) << 4) + (kk & 7) * 2;
}

// T float: the 3xTF32 products above.  T bf16: one m64nNk16 bf16 product
// a k16 step, exact products summed in float32; the rows go to the tensor
// cores as loaded, with no split.
template <int NT, int WGS, bool HAS_SQ, bool BIG, typename T>
__global__ void __launch_bounds__(wg::threads(WGS), 1)
l2_scan_wgmma_kernel(const __grid_constant__ CUtensorMap tm_db,
                     const T* __restrict__ q, const float* __restrict__ sq,
                     const uint8_t* __restrict__ valid,
                     float* __restrict__ part_s, int* __restrict__ part_i,
                     int nq, int n, long long ld_q, int dim, int k,
                     int tiles_per_split, int stages, int slots) {
  using namespace sm90;
  constexpr bool B16 = sizeof(T) == 2;
  constexpr int kDims = wg::kBoxBytes / sizeof(T);  // dims of a box
  const int sp = BIG ? slots : kSlots;
  constexpr int kRows = wg::rows(WGS);
  constexpr int kStage = kRows * wg::kBoxBytes;     // bytes of a ring stage
  constexpr int kConsumers = 128 * WGS, kThreadsB = kConsumers + 32;
  constexpr int kWarps = 4 * WGS;                   // consumer warps
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);    // generic address of base
  const int nbox = (dim + kDims - 1) / kDims;
  const uint32_t qbytes = nbox * NT * 128;            // one query tile
  const uint32_t s_ring = base;
  const uint32_t s_qhi = s_ring + stages * kStage;
  const uint32_t s_qlo = s_qhi + (B16 ? 0 : qbytes);  // bf16: no lo tile
  float* ls = reinterpret_cast<float*>(gbase + (s_qlo + qbytes - base));
  int* li = reinterpret_cast<int*>(ls + NT * sp);
  int* cnt = li + NT * sp;
  float* thr_s = reinterpret_cast<float*>(cnt + NT);
  int* thr_i = reinterpret_cast<int*>(thr_s + NT);
  const uint32_t s_bar = (smem_u32(thr_i + NT) + 7u) & ~7u;
  auto full = [&](int st) { return s_bar + 8u * st; };
  auto empty = [&](int st) { return s_bar + 8u * (stages + st); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * NT;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int n_tiles = (n + kRows - 1) / kRows;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int n_items = max(t_end - t_begin, 0) * nbox;
  const int n_live = min(NT, nq - q0);

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    mbar_fence_init();
  }
  // the query tile as the B operand (K-major, swizzled, dims permuted by
  // logical_k / logical_k16): float32 in TF32 hi and lo parts, bf16 as
  // given; zero past nq and dim
  for (int e = tid; e < nbox * NT * kDims; e += kThreadsB) {
    const int b = e / (NT * kDims), nn = (e / kDims) % NT;
    const int kp = e % kDims;
    const int gq = q0 + nn, gd = b * kDims + kp;
    const bool in = gq < nq && gd < dim;
    if constexpr (B16) {
      bf16* qt = reinterpret_cast<bf16*>(gbase + (s_qhi - base));
      qt[(b * NT * 128 + swz128_16(nn, logical_k16(kp))) / 2] =
          in ? q[gq * ld_q + gd] : __float2bfloat16(0.f);
    } else {
      float* qhi = reinterpret_cast<float*>(gbase + (s_qhi - base));
      float* qlo = reinterpret_cast<float*>(gbase + (s_qlo - base));
      const float v = in ? q[gq * ld_q + gd] : 0.f;
      const float hi = tf32_round(v);
      const int off = (b * NT * 128 + swz128(nn, logical_k(kp))) / 4;
      qhi[off] = hi;
      qlo[off] = tf32_round(v - hi);
    }
  }
  for (int i = tid; i < NT; i += kThreadsB) {
    cnt[i] = 0;
    thr_s[i] = CUDART_INF_F;
    thr_i[i] = kPadId;
  }
  fence_async_smem();                  // the q tiles visible to wgmma
  __syncthreads();

  if (warp == kWarps) {
    // ---- producer: one thread keeps the ring full -------------------------
    if (lane == 0) {
      for (int it = 0; it < n_items; ++it) {
        const int st = it % stages;
        if (it >= stages) mbar_wait(empty(st), ((it / stages) & 1) ^ 1);
        mbar_expect_tx(full(st), kStage);
        tma_load_2d(s_ring + st * kStage, &tm_db, full(st),
                    (it % nbox) * kDims, (t_begin + it / nbox) * kRows);
      }
    }
    return;                            // no block-wide barrier follows
  }

  // ---- consumers: warpgroup cw scores rows 64 cw .. 64 cw + 63 of a tile --
  const int cw = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int lrow = 64 * cw + 16 * (warp & 3) + g;   // rows lrow, lrow + 8
  // The 12 products of a box go round-robin to kChains accumulator sets:
  // a small wgmma is latency, not work, so a box's products must not wait
  // on each other.
  // (three warpgroups leave each thread fewer registers: fewer sets)
  // (a bf16 box has four products: at most four sets)
  constexpr int kChains3 = WGS == 2 ? (NT == 32 ? 4 : NT == 16 ? 6 : 12)
                                   : (NT == 32 ? 2 : NT == 16 ? 3 : 6);
  constexpr int kChains = B16 && kChains3 > 4 ? 4 : kChains3;
  float acc[kChains][NT / 2];
  // the thresholds of this lane's NT / 4 queries (8 jj + 2 t4 + bb), kept
  // in registers: they change only when the lists are tightened
  float ts[NT / 4];
  int ti[NT / 4];
  auto load_thresholds = [&]() {
#pragma unroll
    for (int c = 0; c < NT / 4; ++c) {
      const int qq = 8 * (c >> 1) + 2 * t4 + (c & 1);
      ts[c] = thr_s[qq];
      ti[c] = thr_i[qq];
    }
  };
  load_thresholds();
  int it = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
#pragma unroll
    for (int c = 0; c < kChains; ++c)
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[c][i] = 0.f;
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
      const uint8_t* ring = gbase + st * kStage;
      if constexpr (B16) {
        uint32_t w[2][8];               // rows lrow, lrow + 8: dims 16 t4 ..
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint4 f = *reinterpret_cast<const uint4*>(
                ring + swz128(lrow + 8 * u, 4 * (2 * t4 + h)));
            w[u][4 * h] = f.x;
            w[u][4 * h + 1] = f.y;
            w[u][4 * h + 2] = f.z;
            w[u][4 * h + 3] = f.w;
          }
        mbar_arrive(empty(st));         // the stage is in registers
        if (!HAS_SQ)
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float2 v = widen2(w[u][i]);
              nrm[u] = fmaf(v.x, v.x, nrm[u]);
              nrm[u] = fmaf(v.y, v.y, nrm[u]);
            }
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t a[4] = {w[0][2 * j], w[1][2 * j], w[0][2 * j + 1],
                                 w[1][2 * j + 1]};
          wgmma_bf16<NT>(acc[j % kChains],
                         a, desc_sw128(s_qhi + b * NT * 128 + 32 * j, 16, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < kChains; ++c) fence_regs(acc[c]);
      } else {
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
        mbar_arrive(empty(st));         // the stage is in registers
        if (!HAS_SQ)
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 8; ++e) nrm[u] = fmaf(x[u][e], x[u][e], nrm[u]);
        uint32_t ahi[4][4], alo[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) { // r: (row g | g + 8) x (dim 2j | 2j+1)
            const float v = x[r & 1][2 * j + (r >> 1)];
            const float hi = tf32_round(v);
            ahi[j][r] = __float_as_uint(hi);
            alo[j][r] = __float_as_uint(tf32_round(v - hi));
          }
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t off = b * NT * 128 + 32 * j;
          const uint64_t dhi = desc_sw128(s_qhi + off, 16, 1024);
          const uint64_t dlo = desc_sw128(s_qlo + off, 16, 1024);
          wgmma_tf32<NT>(acc[(3 * j) % kChains], alo[j], dhi);
          wgmma_tf32<NT>(acc[(3 * j + 1) % kChains], ahi[j], dlo);
          wgmma_tf32<NT>(acc[(3 * j + 2) % kChains], ahi[j], dhi);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < kChains; ++c) fence_regs(acc[c]);
      }
    }
#pragma unroll
    for (int c = 1; c < kChains; ++c)
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[0][i] += acc[c][i];
    if (!HAS_SQ)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        nrm[u] += __shfl_xor_sync(kFull, nrm[u], 1);
        nrm[u] += __shfl_xor_sync(kFull, nrm[u], 2);
      }
    // Offer the tile's scores: D's element i is row g + 8 ((i >> 1) & 1),
    // query 8 (i >> 2) + 2 t4 + (i & 1).  Most tiles have no survivor in a
    // warp, so the test is register arithmetic and one vote; only then do
    // the appends run.  A query's 16 scores in a warp sit in the 8 lanes of
    // one t4: the warp takes one slot range per query with survivors (one
    // atomic, from the lowest such lane; the atomics overlap), and each
    // lane writes its survivors at its rank among them.
    const int row0 = tile * kRows + lrow;
    bool take[2][NT / 4];
    float sc[2][NT / 4];
    bool mine = false;
#pragma unroll
    for (int c = 0; c < NT / 4; ++c)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int qq = 8 * (c >> 1) + 2 * t4 + (c & 1);
        sc[u][c] = nrm[u] - 2.0f * acc[0][4 * (c >> 1) + 2 * u + (c & 1)];
        take[u][c] = ok[u] && qq < n_live && sc[u][c] < CUDART_INF_F &&
                     cand_less(sc[u][c], row0 + 8 * u, ts[c], ti[c]);
        mine |= take[u][c];
      }
    bool need = false;
    if (__any_sync(kFull, mine)) {
      const unsigned grp = 0x11111111u << t4;           // lanes of this t4
      const unsigned below = (1u << lane) - 1u;
      unsigned m[2][NT / 4];
      int base[NT / 4];
#pragma unroll
      for (int c = 0; c < NT / 4; ++c) {
        const int qq = 8 * (c >> 1) + 2 * t4 + (c & 1);
        m[0][c] = __ballot_sync(kFull, take[0][c]) & grp;
        m[1][c] = __ballot_sync(kFull, take[1][c]) & grp;
        const unsigned any = m[0][c] | m[1][c];
        base[c] = 0;
        if (any != 0u && lane == __ffs(any) - 1)
          base[c] = atomicAdd(&cnt[qq], __popc(m[0][c]) + __popc(m[1][c]));
      }
#pragma unroll
      for (int c = 0; c < NT / 4; ++c) {
        const unsigned any = m[0][c] | m[1][c];
        const int qq = 8 * (c >> 1) + 2 * t4 + (c & 1);
        const int b = __shfl_sync(kFull, base[c], any ? __ffs(any) - 1 : lane);
        const int n0 = __popc(m[0][c]);
        need |= b + n0 + __popc(m[1][c]) > sp - kRows;
        if (take[0][c]) {
          const int pos = b + __popc(m[0][c] & below);
          ls[qq * sp + pos] = sc[0][c];
          li[qq * sp + pos] = row0;
        }
        if (take[1][c]) {
          const int pos = b + n0 + __popc(m[1][c] & below);
          ls[qq * sp + pos] = sc[1][c];
          li[qq * sp + pos] = row0 + 8;
        }
      }
    }
    // when a list could overflow on the next tile, each warp tightens its
    // lists (query qq belongs to consumer warp qq % 8) that hold more than
    // k: tightening them all at once keeps the lists refilling together,
    // so such stops, where every consumer waits, stay rare
    if (bar_or(1, kConsumers, need)) {
      for (int qq = warp; qq < n_live; qq += kWarps) {
        const int c = cnt[qq];
        if (c > k) {
          const Tight tt = tighten_list<BIG>(ls + qq * sp, li + qq * sp, c, k,
                                             kRows, sp);
          if (lane == 0) {
            cnt[qq] = tt.cnt;
            thr_s[qq] = tt.thr.s;
            thr_i[qq] = tt.thr.i;
          }
        }
      }
      bar_sync(2, kConsumers);
      load_thresholds();
    }
  }
  for (int qq = warp; qq < n_live; qq += kWarps) {
    float* s_l = ls + qq * sp;
    int* i_l = li + qq * sp;
    int c = cnt[qq];
    if (c > k) c = tighten_list<BIG>(s_l, i_l, c, k, kRows, sp).cnt;
    const size_t o = ((size_t)(q0 + qq) * n_split + split) * k;
    emit_list<BIG>(s_l, i_l, c, k, part_s + o, part_i + o);
  }
}

// Pass 2.  grid = nq * n_groups, block = kMergeThreads: block (query,
// group) folds that query's sorted lists [group * per_group, ...) of the
// n_in it has into one sorted list of k.  Each round, warp w < W (W =
// merge_warps(kp)) reads list (round * W + w) 32 entries at a time and
// stops at the first entry that does not beat the current k-th best: the
// list ascends, so nothing after it can.
template <bool BIG>
__global__ void __launch_bounds__(kMergeThreads)
l2_merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
                float* __restrict__ out_s, int* __restrict__ out_i,
                int n_in, int per_group, int k, int kp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = BIG ? merge_warps(kp) : kMergeWarps;
  const int sp = merge_slots(kp, w);
  float* ls = reinterpret_cast<float*>(smem_raw);
  int* li = reinterpret_cast<int*>(ls + sp);
  int* cnt = li + sp;
  int* thr_i = cnt + 1;
  float* thr_s = reinterpret_cast<float*>(thr_i + 1);
  const int n_groups = (n_in + per_group - 1) / per_group;
  const int gq = blockIdx.x / n_groups, grp = blockIdx.x % n_groups;
  const int l0 = grp * per_group, l1 = min(n_in, l0 + per_group);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cap = sp - kp;

  init_lists(ls, li, cnt, thr_s, thr_i, 1, sp);
  for (int base = l0; base < l1; base += w) {
    const int split = base + warp;
    if (warp < w && split < l1) {
      const size_t off = ((size_t)gq * n_in + split) * k;
      for (int j0 = 0; j0 < k; j0 += 32) {
        const int j = j0 + lane;
        bool take = false;
        float s = CUDART_INF_F;
        int id = kPadId;
        if (j < k) {
          s = part_s[off + j];
          if (s < CUDART_INF_F) {
            id = part_i[off + j];
            take = cand_less(s, id, thr_s[0], thr_i[0]);
          }
        }
        if (take) {
          const int pos = atomicAdd(&cnt[0], 1);
          ls[kp + pos] = s;
          li[kp + pos] = id;
        }
        if (__any_sync(0xffffffffu, j < k && !take)) break;
      }
    }
    __syncthreads();
    if (__syncthreads_or(threadIdx.x == 0 && cnt[0] > cap - w * k))
      merge_pending(ls, li, cnt, thr_s, thr_i, sp, kp, k);
  }
  merge_pending(ls, li, cnt, thr_s, thr_i, sp, kp, k);
  const size_t o = ((size_t)gq * n_groups + grp) * k;
  for (int j = threadIdx.x; j < k; j += kMergeThreads) {
    const float s = ls[j];
    out_s[o + j] = s;
    out_i[o + j] = s < CUDART_INF_F ? li[j] : -1;
  }
}

// The arguments of a call, packed by the wrapper into one buffer (a ctypes
// argument costs about a microsecond).
struct L2Args {
  const void* q;            // (nq, ld_q) float32 or bf16 (`bf16`), as db
  const void* db;           // (n, ld_db) rows
  const float* sq;          // (n,) prefix norms at dim, or null
  const uint8_t* valid;     // (n,) bytes, or null (all valid)
  float* part_s;            // (nq, n_split, k) pass-1 lists
  int* part_i;
  float* mid_s;             // (nq, n_groups, k) merged groups (n_groups > 1)
  int* mid_i;
  float* out_s;             // (nq, k)
  int* out_i;
  void* stream;
  long long ld_q, ld_db;
  int nq, n, dim, k;
  int kind;                 // 0: fma, 1: wgmma
  int tile_q;               // fma: queries a warp (1, 2, 4); wgmma: NT (8, 16, 32)
  int vec;                  // fma: 16-byte loads
  int n_split, tiles_per_split;
  int n_groups;             // pass 2: groups of up to 32 lists per query
  int stages;               // wgmma: ring stages
  int wgs;                  // wgmma: consumer warpgroups (64 rows each)
  int bf16;                 // != 0: q and db are bf16, else float32
};

template <int RQ, bool VEC, bool HAS_SQ, bool BIG, typename T>
cudaError_t launch_scan(const L2Args& a, cudaStream_t stream) {
  constexpr int QT = 8 * RQ;
  const int slots = list_slots(a.k);
  const size_t smem = scan_smem_bytes(QT, a.dim, slots);
  auto kern = l2_scan_kernel<RQ, VEC, HAS_SQ, BIG, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.n_split, (a.nq + QT - 1) / QT);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.db), a.sq, a.valid,
      a.part_s, a.part_i, a.nq, a.n, (int)a.ld_q, (int)a.ld_db, a.dim, a.k,
      a.tiles_per_split, slots);
  return cudaGetLastError();
}

template <int RQ, bool BIG, typename T>
cudaError_t dispatch_scan_t(const L2Args& a, cudaStream_t st) {
  const bool has_sq = a.sq != nullptr;
  if (a.vec && has_sq) return launch_scan<RQ, true, true, BIG, T>(a, st);
  if (a.vec) return launch_scan<RQ, true, false, BIG, T>(a, st);
  if (has_sq) return launch_scan<RQ, false, true, BIG, T>(a, st);
  return launch_scan<RQ, false, false, BIG, T>(a, st);
}

// The row type of this library.
using Elem = L2_ELEM;

template <int RQ, bool BIG>
cudaError_t dispatch_scan(const L2Args& a, cudaStream_t st) {
  return dispatch_scan_t<RQ, BIG, Elem>(a, st);
}

template <int NT, int WGS, bool HAS_SQ, bool BIG, typename T>
cudaError_t launch_wgmma_nt(const L2Args& a, const CUtensorMap& tm,
                            cudaStream_t st) {
  const int slots = list_slots(a.k);
  const size_t smem = wgmma_smem_bytes(NT, a.dim, a.stages, WGS, slots,
                                       sizeof(T) == 2);
  auto kern = l2_scan_wgmma_kernel<NT, WGS, HAS_SQ, BIG, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.nq + NT - 1) / NT, a.n_split);
  kern<<<grid, wg::threads(WGS), smem, st>>>(
      tm, static_cast<const T*>(a.q), a.sq, a.valid, a.part_s, a.part_i, a.nq,
      a.n, a.ld_q, a.dim, a.k, a.tiles_per_split, a.stages, slots);
  return cudaGetLastError();
}

template <int NT, int WGS, bool BIG>
cudaError_t launch_wgmma_typed(const L2Args& a, const CUtensorMap& tm,
                               cudaStream_t st) {
  return a.sq != nullptr
             ? launch_wgmma_nt<NT, WGS, true, BIG, Elem>(a, tm, st)
             : launch_wgmma_nt<NT, WGS, false, BIG, Elem>(a, tm, st);
}

cudaError_t launch_wgmma(const L2Args& a, cudaStream_t st) {
  // TMA: a 16-byte aligned base and row stride; float32 dims a multiple
  // of 4, bf16 dims a multiple of 16 (one k16 step)
  const int esize = a.bf16 ? 2 : 4;
  if (a.stages < 2 || a.stages > wg::kMaxStages || a.dim % (a.bf16 ? 16 : 4) ||
      a.n < 1 || (a.ld_db * esize) % 16 ||
      reinterpret_cast<uintptr_t>(a.db) % 16)
    return cudaErrorInvalidValue;
  const sm90::EncodeTiled enc = sm90::encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  // the rows' [:dim] prefix: a (n, dim) tensor at row stride ld_db, in
  // boxes of 128 bytes (32 float32 or 64 bf16 dims) x 64 wgs rows; dims
  // past `dim`, rows past n read as 0
  CUtensorMap tm;
  const cuuint64_t dims[2] = {(cuuint64_t)a.dim, (cuuint64_t)a.n};
  const cuuint64_t strides[1] = {(cuuint64_t)a.ld_db * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(wg::kBoxBytes / esize),
                             (cuuint32_t)wg::rows(a.wgs)};
  const cuuint32_t unit[2] = {1, 1};
  if (enc(&tm, a.bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
          2, const_cast<void*>(a.db), dims, strides, box, unit,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const bool big = list_slots(a.k) > kSlots;
#define L2_WGMMA(NT, WGS, BIG)                                             \
  if (a.tile_q == NT && a.wgs == WGS && big == BIG)                        \
    return launch_wgmma_typed<NT, WGS, BIG>(a, tm, st);
  L2_WGMMA(8, 2, false) L2_WGMMA(16, 2, false) L2_WGMMA(32, 2, false)
  L2_WGMMA(8, 3, false) L2_WGMMA(16, 3, false) L2_WGMMA(32, 3, false)
  // large k: lists of 1,024 or 2,048 slots leave room for 16 or 8 queries
  L2_WGMMA(8, 2, true) L2_WGMMA(16, 2, true)
#undef L2_WGMMA
  return cudaErrorInvalidValue;
}

cudaError_t launch_merge(const float* in_s, const int* in_i, float* out_s,
                         int* out_i, int nq, int n_in, int per_group, int k,
                         cudaStream_t st) {
  const int kp = next_pow2(k);
  const bool big = kp > 256;
  const int sp = merge_slots(kp, merge_warps(kp));
  const size_t smem = (sizeof(float) + sizeof(int)) * sp
                    + 2 * sizeof(int) + sizeof(float);
  auto kern = big ? l2_merge_kernel<true> : l2_merge_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_groups = (n_in + per_group - 1) / per_group;
  kern<<<nq * n_groups, kMergeThreads, smem, st>>>(
      in_s, in_i, out_s, out_i, n_in, per_group, k, kp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one pass-1 block of the FMA kernel (rq =
// queries per warp: 1, 2 or 4; float32 in shared memory for either input
// type) and of the tensor-core kernel (nt queries, `stages` ring stages,
// bf16 or float32 rows), for the wrapper's choice of tiles.
size_t l2_topk_scan_smem(int rq, int dim, int slots) {
  return scan_smem_bytes(8 * rq, dim, slots);
}

size_t l2_topk_wgmma_smem(int nt, int dim, int stages, int wgs, int slots,
                          int bf16) {
  return wgmma_smem_bytes(nt, dim, stages, wgs, slots, bf16 != 0);
}

// Slots of a pass-1 list at k, for the wrapper's check of its own copy.
int l2_topk_list_slots(int k) { return list_slots(k); }

int l2_topk_args_size() { return (int)sizeof(L2Args); }

// Runs pass 1 (the kernel `kind` names) and pass 2 on the arguments packed
// at `args` (an L2Args of this library's row type).  Returns the first CUDA
// error of the launches (0 on success).
int l2_topk_launch(const void* args) {
  const L2Args& a = *static_cast<const L2Args*>(args);
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  cudaError_t err;
  const bool big = list_slots(a.k) > kSlots;
  if (a.k < 1 || a.k > 1024 || (a.bf16 != 0) != (sizeof(Elem) == 2))
    err = cudaErrorInvalidValue;
  else if (a.kind == 1)
    err = launch_wgmma(a, st);
  else if (a.tile_q == 4 && !big)
    err = dispatch_scan<4, false>(a, st);
  else if (a.tile_q == 2)
    err = big ? dispatch_scan<2, true>(a, st) : dispatch_scan<2, false>(a, st);
  else if (a.tile_q == 1)
    err = big ? dispatch_scan<1, true>(a, st) : dispatch_scan<1, false>(a, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  if (a.n_groups > 1) {
    const int per_group = (a.n_split + a.n_groups - 1) / a.n_groups;
    err = launch_merge(a.part_s, a.part_i, a.mid_s, a.mid_i, a.nq, a.n_split,
                       per_group, a.k, st);
    if (err != cudaSuccess) return (int)err;
    err = launch_merge(a.mid_s, a.mid_i, a.out_s, a.out_i, a.nq,
                       (a.n_split + per_group - 1) / per_group, a.n_split, a.k,
                       st);
  } else {
    err = launch_merge(a.part_s, a.part_i, a.out_s, a.out_i, a.nq, a.n_split,
                       a.n_split, a.k, st);
  }
  return (int)err;
}

// Human-readable name of a CUDA error code returned by the launcher.
const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
