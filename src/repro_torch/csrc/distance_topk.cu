// Stage-0 fused truncated-L2 scan with top-k, for Hopper (sm_90a).
//
// Replaces the TPU kernel `l2_topk` of the JAX package
// (src/repro/kernels/distance_topk.py): score every stored row against a
// batch of queries over the first `dim` dims and keep the best k per query,
// without writing the (Q, N) score matrix anywhere.
//
// Bound on an H100 SXM: one read of the [:dim] prefix of every row plus its
// prefix norm and validity byte (N * (4*dim + 5) bytes; 1M rows at dim 128
// is 542 MB, 0.16 ms at 3.35 TB/s) against 2*Q*N*dim float32 operations
// (8.6 GFLOP at Q=32, 0.13 ms at 67 TFLOP/s).  Memory-bound, with compute
// close behind at the top bucket.
//
// Design.  The TPU kernel carries its top-k across a sequential grid; a
// Hopper grid has no order, so the scan has two passes:
//   pass 1 (l2_scan_kernel): the doc axis is split into contiguous ranges,
//     one block per (range, query tile) and one block per SM.  A block
//     streams 128-row tiles of its range, 64 dims at a time, through a
//     two-stage shared-memory ring filled by cp.async (each warp copies
//     whole 256-byte row pieces), so the next chunk is in flight while the
//     current one is multiplied.  Each warp owns RQ queries and scores them
//     against the tile's rows (4 per lane) in float32 FMA from swizzled,
//     bank-conflict-free shared-memory reads.  Because a warp owns its
//     queries, the top-k selection is warp-local: scores that beat a
//     query's threshold are appended to its 512-slot list with a ballot.
//     When a list nears full the warp tightens it: a radix select finds the
//     k-th best score and the list keeps only what can still make the
//     top-k.  The threshold closes in as the scan goes, so a block tightens
//     about once; only the final list of about k entries is sorted, in
//     registers.  Each block writes its sorted top-k to a (Q, n_split, k)
//     scratch.  (Sorting the lists at every fold instead, first in shared
//     memory and then in registers, cost more than the scan itself: each
//     fold stalls the whole block at the next tile barrier.)
//   pass 2 (l2_merge_kernel): one block per query folds the n_split
//     partial lists into the final (Q, k) with the same tie order: a warp
//     per list reads it from the front and stops at the first entry that
//     cannot beat the current k-th best (the lists are sorted), so most
//     lists cost one 32-entry read.
// Ties order by (score, row index); slots with no finite score return -1.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

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

// Folds each list's pending buffer into its running top-k.
//
// List `l` holds its sorted top-kp in [0, kp) and `cnt[l]` pending
// candidates in [kp, kp + cnt[l]); the rest of its `sp` slots are stale.
// After the call [0, kp) is the sorted top-kp of both, cnt is 0 and
// (thr_s, thr_i) is the k-th best candidate: a new candidate enters the
// buffer only if it ranks before it.
__device__ void merge_pending(float* s, int* id, int* cnt, float* thr_s,
                              int* thr_i, int nlists, int sp, int kp, int k) {
  const int log_sp = __ffs(sp) - 1;
  for (int t = threadIdx.x; t < nlists * sp; t += blockDim.x) {
    const int list = t >> log_sp;
    const int j = t & (sp - 1);
    if (j >= kp + cnt[list]) {
      s[t] = CUDART_INF_F;
      id[t] = kPadId;
    }
  }
  __syncthreads();
  bitonic_sort_lists(s, id, nlists, sp);
  for (int l = threadIdx.x; l < nlists; l += blockDim.x) {
    cnt[l] = 0;
    thr_s[l] = s[l * sp + k - 1];
    thr_i[l] = id[l * sp + k - 1];
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

// Slots of the pass-2 list: the running top-kp plus room for 1.5 rounds
// of kMergeWarps lists of up to kp entries each.
__host__ __device__ inline int merge_slots(int kp) {
  return next_pow2(kp + kMergeWarps * kp + kMergeWarps * kp / 2);
}

// Pass-1 shared memory: two ring stages of rows, the query chunk (one copy
// when dim fits one chunk, else one per stage) and QT lists of kSlots.
__host__ __device__ inline size_t scan_smem_bytes(int qt, int dim) {
  const int q_copies = dim <= kChunkD ? 1 : 2;
  return sizeof(float) * (2 * (size_t)kStage + (size_t)q_copies * qt * kChunkD)
       + (sizeof(float) + sizeof(int)) * (size_t)qt * kSlots;
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
// top-k and returns the tighter threshold.  Called by the whole owning warp
// with warp-uniform arguments.  A radix select over the score bits (32
// warp-wide counts) finds the k-th smallest score T; the list keeps every
// entry scoring <= T (at least k, ties included) and the threshold admits
// scores <= T, so nothing of the top-k is ever dropped.  No sort: the
// select is a few hundred instructions, far cheaper than a bitonic fold of
// the list.  Should ties at T leave the list too full for the next tile,
// an exact sort keeps precisely the top-k instead.
__device__ __noinline__ Tight tighten(float* s, int* id, int cnt, int k) {
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
  }
  __syncwarp();
  int kept = 0;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const bool keep = key[i] <= prefix && i * 32 + lane < cnt;
    const unsigned m = __ballot_sync(kFull, keep);
    if (keep) {
      const int pos = kept + __popc(m & ((1u << lane) - 1u));
      s[pos] = v[i];
      id[pos] = w[i];
    }
    kept += __popc(m);
  }
  __syncwarp();
  if (kept <= kSlots - kTileN) return Tight{kept, Cand{key_float(prefix), kPadId}};
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

// Pass 1.  grid = (n_split, ceil(nq / QT)), block = kThreads, one block per
// SM.  Warp w owns queries w*RQ .. w*RQ+RQ-1 of the tile and their lists.
template <int RQ, bool VEC, bool HAS_SQ>
__global__ void __launch_bounds__(kThreads, 1)
l2_scan_kernel(const float* __restrict__ q, const float* __restrict__ db,
               const float* __restrict__ sq, const uint8_t* __restrict__ valid,
               float* __restrict__ part_s, int* __restrict__ part_i,
               int nq, int n, int ld_q, int ld_db, int dim, int k,
               int tiles_per_split) {
  constexpr int QT = 8 * RQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int sp = kSlots;
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
          const Tight t = tighten(ls + (warp * RQ + r) * sp,
                                  li + (warp * RQ + r) * sp, cnt[r], k);
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
    if (cnt[r] > k) cnt[r] = tighten(s_l, i_l, cnt[r], k).cnt;
    const size_t o = ((size_t)(q0 + warp * RQ + r) * n_split + split) * k;
    emit_sorted(s_l, i_l, cnt[r], k, part_s + o, part_i + o);
  }
}

// Pass 2.  grid = nq, block = kMergeThreads: fold n_split sorted lists of
// k.  Each round, warp w reads list (round * kMergeWarps + w) 32 entries at
// a time and stops at the first entry that does not beat the current k-th
// best: the list ascends, so nothing after it can.
__global__ void __launch_bounds__(kMergeThreads)
l2_merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
                float* __restrict__ out_s, int* __restrict__ out_i,
                int n_split, int k, int kp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = merge_slots(kp);
  float* ls = reinterpret_cast<float*>(smem_raw);
  int* li = reinterpret_cast<int*>(ls + sp);
  int* cnt = li + sp;
  int* thr_i = cnt + 1;
  float* thr_s = reinterpret_cast<float*>(thr_i + 1);
  const int gq = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cap = sp - kp;

  init_lists(ls, li, cnt, thr_s, thr_i, 1, sp);
  for (int base = 0; base < n_split; base += kMergeWarps) {
    const int split = base + warp;
    if (split < n_split) {
      const size_t off = ((size_t)gq * n_split + split) * k;
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
    if (__syncthreads_or(threadIdx.x == 0 && cnt[0] > cap - kMergeWarps * k))
      merge_pending(ls, li, cnt, thr_s, thr_i, 1, sp, kp, k);
  }
  merge_pending(ls, li, cnt, thr_s, thr_i, 1, sp, kp, k);
  for (int j = threadIdx.x; j < k; j += kMergeThreads) {
    const float s = ls[j];
    out_s[(size_t)gq * k + j] = s;
    out_i[(size_t)gq * k + j] = s < CUDART_INF_F ? li[j] : -1;
  }
}

template <int RQ, bool VEC, bool HAS_SQ>
cudaError_t launch_scan(const float* q, const float* db, const float* sq,
                        const uint8_t* valid, float* part_s, int* part_i,
                        int nq, int n, int ld_q, int ld_db, int dim, int k,
                        int n_split, int tiles_per_split,
                        cudaStream_t stream) {
  constexpr int QT = 8 * RQ;
  const size_t smem = scan_smem_bytes(QT, dim);
  auto kern = l2_scan_kernel<RQ, VEC, HAS_SQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_split, (nq + QT - 1) / QT);
  kern<<<grid, kThreads, smem, stream>>>(q, db, sq, valid, part_s, part_i, nq,
                                         n, ld_q, ld_db, dim, k,
                                         tiles_per_split);
  return cudaGetLastError();
}

template <int RQ>
cudaError_t dispatch_scan(bool vec, bool has_sq, const float* q,
                          const float* db, const float* sq,
                          const uint8_t* valid, float* part_s, int* part_i,
                          int nq, int n, int ld_q, int ld_db, int dim, int k,
                          int n_split, int tiles_per_split,
                          cudaStream_t st) {
  if (vec && has_sq)
    return launch_scan<RQ, true, true>(q, db, sq, valid, part_s, part_i, nq, n,
                                       ld_q, ld_db, dim, k, n_split,
                                       tiles_per_split, st);
  if (vec)
    return launch_scan<RQ, true, false>(q, db, sq, valid, part_s, part_i, nq,
                                        n, ld_q, ld_db, dim, k, n_split,
                                        tiles_per_split, st);
  if (has_sq)
    return launch_scan<RQ, false, true>(q, db, sq, valid, part_s, part_i, nq,
                                        n, ld_q, ld_db, dim, k, n_split,
                                        tiles_per_split, st);
  return launch_scan<RQ, false, false>(q, db, sq, valid, part_s, part_i, nq, n,
                                       ld_q, ld_db, dim, k, n_split,
                                       tiles_per_split, st);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one pass-1 block (rq = queries per warp: 1, 2
// or 4), for the wrapper's choice of rq.
size_t l2_topk_scan_smem(int rq, int dim) {
  return scan_smem_bytes(8 * rq, dim);
}

// q (nq, ld_q) and db (n, ld_db) float32 row-major; sq (n,) float32 prefix
// norms at `dim` or null (computed from the rows); valid (n,) bytes or null
// (all rows valid); part_s/part_i (nq, n_split, k) scratch; out (nq, k).
// Returns the first CUDA error of the two launches (0 on success).
int l2_topk_launch(const float* q, const float* db, const float* sq,
                   const uint8_t* valid, float* part_s, int* part_i,
                   float* out_s, int* out_i, int nq, int n, int ld_q,
                   int ld_db, int dim, int k, int rq, int vec, int n_split,
                   int tiles_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kp = next_pow2(k);
  cudaError_t err;
  const bool has_sq = sq != nullptr;
  if (rq == 4)
    err = dispatch_scan<4>(vec != 0, has_sq, q, db, sq, valid, part_s, part_i,
                           nq, n, ld_q, ld_db, dim, k, n_split,
                           tiles_per_split, st);
  else if (rq == 2)
    err = dispatch_scan<2>(vec != 0, has_sq, q, db, sq, valid, part_s, part_i,
                           nq, n, ld_q, ld_db, dim, k, n_split,
                           tiles_per_split, st);
  else
    err = dispatch_scan<1>(vec != 0, has_sq, q, db, sq, valid, part_s, part_i,
                           nq, n, ld_q, ld_db, dim, k, n_split,
                           tiles_per_split, st);
  if (err != cudaSuccess) return (int)err;
  const int sp = merge_slots(kp);
  const size_t smem = (sizeof(float) + sizeof(int)) * sp
                    + 2 * sizeof(int) + sizeof(float);
  err = cudaFuncSetAttribute(l2_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  l2_merge_kernel<<<nq, kMergeThreads, smem, st>>>(part_s, part_i, out_s,
                                                   out_i, n_split, k, kp);
  return (int)cudaGetLastError();
}

// Human-readable name of a CUDA error code returned by the launcher.
const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
