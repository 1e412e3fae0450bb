// Top-k selection shared by the PQ and IVF scan kernels (pq_scan.cu,
// list_scan.cuh).
//
// A candidate is one 64-bit key: the score mapped to an order-preserving
// 32-bit integer in the high half, its scan position in the low half.  So
// keys order by (score, scan position) — the order lax.top_k gives over the
// scan's candidate table — and no two keys are equal.  Only finite scores
// are ever offered: a slot left without a key is (+inf, -1).
//
// The flat PQ scan keeps a list per query of its tile and cuts each with
// warp_tighten, a radix select by one warp; it writes each range's top-k
// as keys, and merge_kernel (pass 2, 1,024 threads) streams a query's part
// lists through the block's streaming selection (`Selector`: keys below
// the threshold appended to a shared-memory buffer, one atomic a warp; a
// bitonic sort keeps the k smallest when the buffer could overflow) and
// turns the final keys into (score, id).  The list-major scans
// (list_scan.cuh) select with a block-wide radix select instead.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace scan_topk {

typedef unsigned long long Key;

constexpr int kTile = 1024;            // rows (or keys) offered per tile
constexpr int kMergeThreads = 1024;
constexpr Key kEmpty = ~0ull;

__device__ __forceinline__ Key make_key(float s, unsigned pos) {
  if (s == 0.f) s = 0.f;               // -0 ranks with +0
  unsigned u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<Key>(u) << 32) | pos;
}

__device__ __forceinline__ float key_score(Key key) {
  const unsigned o = static_cast<unsigned>(key >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Keys the selection buffer holds: a power of two >= k + kTile.
inline int buffer_cap(int k) {
  int cap = 1;
  while (cap < k + kTile) cap <<= 1;
  return cap;
}

// Ascending bitonic sort of buf[0, n), padded with kEmpty to a power of
// two (which must fit the buffer).  Every thread of the block calls it.
__device__ void block_sort(Key* buf, int n) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int i = n + threadIdx.x; i < n2; i += blockDim.x) buf[i] = kEmpty;
  __syncthreads();
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (n2 >> 1); t += blockDim.x) {
        const int i = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const int j = i + stride;
        const Key a = buf[i], b = buf[j];
        if ((a > b) == ((i & size) == 0)) {
          buf[i] = b;
          buf[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// One warp shrinks a list of n distinct keys (n > k) to the keys at or
// below a pivot P that has at least k keys at or below it and at most
// `limit` (limit >= k), and returns how many it kept (in buf[0, kept),
// unordered); *thr becomes the bound a later key must stay below.  A radix
// select by 8-bit digits from the top: each pass histograms the keys that
// share the pivot's digits so far (`hist`: 256 ints of this warp's), takes
// the digit holding the k-th key, and stops once the keys at or below that
// bucket fit `limit` — usually after two passes (the score's sign, exponent
// and 7 mantissa bits).  With limit == k it runs to the exact k-th key, the
// keys being distinct.  No sort: a few hundred instructions a pass.
__device__ int warp_tighten(Key* buf, int n, int k, int limit, int* hist,
                            Key* thr) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  // the leading bytes every key shares need no pass: start at the first
  // byte in which two keys differ
  Key k_or = 0, k_and = ~0ull;
  for (int i = lane; i < n; i += 32) {
    const Key x = buf[i];
    k_or |= x;
    k_and &= x;
  }
  const unsigned or_hi = __reduce_or_sync(kAll, static_cast<unsigned>(k_or >> 32));
  const unsigned or_lo = __reduce_or_sync(kAll, static_cast<unsigned>(k_or));
  const unsigned and_hi = __reduce_and_sync(kAll, static_cast<unsigned>(k_and >> 32));
  const unsigned and_lo = __reduce_and_sync(kAll, static_cast<unsigned>(k_and));
  const Key diff = (static_cast<Key>(or_hi ^ and_hi) << 32) | (or_lo ^ and_lo);
  const int start = diff ? ((63 - __clzll(static_cast<long long>(diff))) / 8) * 8 : 0;
  Key hi_mask = start == 56 ? 0ull : ~((1ull << (start + 8)) - 1);
  Key prefix = ((static_cast<Key>(and_hi) << 32) | and_lo) & hi_mask;
  Key top = ~0ull;
  int below = 0, need = k;          // keys below the bucket; rank inside it
  for (int shift = start; shift >= 0; shift -= 8) {
    for (int i = lane; i < 256; i += 32) hist[i] = 0;
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      const Key key = buf[i];
      if ((key & hi_mask) == prefix)
        atomicAdd(&hist[static_cast<int>((key >> shift) & 255)], 1);
    }
    __syncwarp();
    int h[8], sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      h[j] = hist[lane * 8 + j];
      sum += h[j];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kAll, incl, off);
      if (lane >= off) incl += t;
    }
    const int excl = incl - sum;
    const int src = __ffs(__ballot_sync(kAll, excl < need && need <= incl)) - 1;
    int digit = 0, before = 0, in_bucket = 0, run = excl;
    bool found = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!found && run + h[j] >= need) {
        found = true;
        digit = lane * 8 + j;
        before = run;
        in_bucket = h[j];
      }
      run += h[j];
    }
    digit = __shfl_sync(kAll, digit, src);
    before = __shfl_sync(kAll, before, src);
    in_bucket = __shfl_sync(kAll, in_bucket, src);
    below += before;
    need -= before;
    prefix |= static_cast<Key>(digit) << shift;
    hi_mask |= static_cast<Key>(255) << shift;
    top = prefix | (shift ? (1ull << shift) - 1 : 0ull);
    if (below + in_bucket <= limit) break;
  }
  int kept = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const Key key = i < n ? buf[i] : ~0ull;
    const bool keep = i < n && key <= top;
    const unsigned m = __ballot_sync(kAll, keep);
    if (keep) buf[kept + __popc(m & ((1u << lane) - 1u))] = key;
    kept += __popc(m);
  }
  __syncwarp();
  *thr = top == ~0ull ? top : top + 1;
  return kept;
}

// The streaming selection of one block.  Every thread holds the same
// threshold; the buffer and its counter live in shared memory.
struct Selector {
  Key* buf;
  int* cnt;
  int cap, k;
  Key thr;

  __device__ void init(Key* b, int* c, int cap_, int k_) {
    buf = b;
    cnt = c;
    cap = cap_;
    k = k_;
    thr = kEmpty;
    if (threadIdx.x == 0) *cnt = 0;    // the caller synchronises
  }

  // One atomic for all the takers of a warp that offer together.
  __device__ __forceinline__ void offer(Key key) {
    if (!(key < thr)) return;
    cooperative_groups::coalesced_group g =
        cooperative_groups::coalesced_threads();
    int base = 0;
    if (g.thread_rank() == 0) base = atomicAdd(cnt, static_cast<int>(g.size()));
    buf[g.shfl(base, 0) + g.thread_rank()] = key;
  }

  // Sort the n buffered keys and keep the k smallest.
  __device__ void shrink(int n) {
    block_sort(buf, n);
    if (n >= k) thr = buf[k - 1];
    __syncthreads();
    if (threadIdx.x == 0) *cnt = n < k ? n : k;
    __syncthreads();
  }

  // Make room for `incoming` offers.  Called by every thread after the
  // previous tile's offers and a __syncthreads.
  __device__ void reserve(int incoming) {
    const int n = *cnt;
    __syncthreads();
    if (n + incoming > cap) shrink(n);
  }

  // After the last tile (and a __syncthreads): buf[0, return value) holds
  // the selected keys in ascending order.
  __device__ int finish() {
    const int n = *cnt;
    __syncthreads();
    shrink(n);
    return n < k ? n : k;
  }
};

// Result id of a flat scan: the row's own entry of the id table.
struct FlatIds {
  const int* ids;
  __device__ int operator()(int, unsigned pos) const { return ids[pos]; }
};

// Pass 2: one block per query merges its n_in part keys into the top-k.
template <class IdOf>
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const Key* __restrict__ part, int n_in, int k, int cap,
             float* __restrict__ out_s, int* __restrict__ out_i, IdOf id_of) {
  extern __shared__ __align__(16) unsigned char smem[];
  Key* buf = reinterpret_cast<Key*>(smem);
  int* cnt = reinterpret_cast<int*>(buf + cap);
  const int qi = blockIdx.x;
  Selector sel;
  sel.init(buf, cnt, cap, k);
  __syncthreads();
  const Key* in = part + static_cast<size_t>(qi) * n_in;
  static_assert(kMergeThreads == kTile, "a merge thread offers one key a tile");
  // each thread's key of the next tile is loaded before this tile's offers
  Key next = threadIdx.x < n_in ? in[threadIdx.x] : kEmpty;
  for (int t0 = 0; t0 < n_in; t0 += kTile) {
    const int tn = min(kTile, n_in - t0);
    sel.reserve(tn);
    const Key key = next;
    if (t0 + kTile + static_cast<int>(threadIdx.x) < n_in)
      next = in[t0 + kTile + threadIdx.x];
    if (static_cast<int>(threadIdx.x) < tn) sel.offer(key);
    __syncthreads();
  }
  const int n = sel.finish();
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    const size_t o = static_cast<size_t>(qi) * k + r;
    if (r < n) {
      out_s[o] = key_score(buf[r]);
      out_i[o] = id_of(qi, static_cast<unsigned>(buf[r]));
    } else {
      out_s[o] = CUDART_INF_F;
      out_i[o] = -1;
    }
  }
}

// Lets `kern` take `bytes` of dynamic shared memory on the current device,
// setting the attribute only when a launch needs more than any before
// (`allowed`: the caller's record for this kernel, one entry a device).
template <class Kernel>
cudaError_t allow_smem(Kernel* kern, int bytes, int (&allowed)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || bytes <= allowed[dev & 63]) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) allowed[dev & 63] = bytes;
  return err;
}

template <class IdOf>
cudaError_t launch_merge(const Key* part, int nq, int n_in, int k,
                         float* out_s, int* out_i, IdOf id_of,
                         cudaStream_t st) {
  const int cap = buffer_cap(k);
  const size_t smem = sizeof(Key) * cap + 16;
  static int allowed[64];
  cudaError_t err =
      allow_smem(merge_kernel<IdOf>, static_cast<int>(smem), allowed);
  if (err != cudaSuccess) return err;
  merge_kernel<IdOf><<<nq, kMergeThreads, smem, st>>>(part, n_in, k, cap, out_s,
                                                 out_i, id_of);
  return cudaGetLastError();
}

}  // namespace scan_topk
