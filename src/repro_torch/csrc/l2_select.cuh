// What the stage-0 scan's pass-1 kernels share (csrc/distance_topk.cuh's
// `fma` and `wgmma`, csrc/distance_topk_wide.cu's `wide`): the per-query
// candidate lists in shared memory and their selection (threshold test,
// radix-select `tighten`, sorted `emit`), the float32 layout of a 128-byte
// TMA box under the 128-byte swizzle with the TF32 split's k order, and
// pass 2, which folds the pass-1 lists of every query into its top k.
// Each library that includes it compiles its own copy.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

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

// Pass 2 of a call: each query's n_split lists folded into out in one
// launch, or, with n_groups > 1, first in groups into mid, then the groups'
// lists into out.
cudaError_t launch_merges(const float* part_s, const int* part_i,
                          float* mid_s, int* mid_i, float* out_s, int* out_i,
                          int nq, int n_split, int n_groups, int k,
                          cudaStream_t st) {
  if (n_groups <= 1)
    return launch_merge(part_s, part_i, out_s, out_i, nq, n_split, n_split,
                        k, st);
  const int per_group = (n_split + n_groups - 1) / n_groups;
  const cudaError_t err = launch_merge(part_s, part_i, mid_s, mid_i, nq,
                                       n_split, per_group, k, st);
  if (err != cudaSuccess) return err;
  return launch_merge(mid_s, mid_i, out_s, out_i, nq,
                      (n_split + per_group - 1) / per_group, n_split, k, st);
}

}  // namespace
