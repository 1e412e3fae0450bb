// Block-wide streaming top-k selection shared by the IVF and PQ scan
// kernels (ivf_scan.cu, pq_scan.cu).
//
// A candidate is one 64-bit key: the score mapped to an order-preserving
// 32-bit integer in the high half, its scan position in the low half.  So
// keys order by (score, scan position) — the order lax.top_k gives over the
// scan's candidate table — and no two keys are equal.  A block offers keys
// from its rows; each key below the block's threshold is appended to a
// buffer in shared memory with an atomic counter.  Before a tile whose
// offers could overflow the buffer, the block sorts it (bitonic, in shared
// memory), keeps the k smallest and sets the threshold to the k-th, so
// later rows that cannot make the top-k are dropped at once.  Only finite
// scores are ever offered: a slot left without a key is (+inf, -1).
//
// Pass 1 of each scan keeps such a top-k per (query, part of the rows) and
// writes it as keys; pass 2 (merge_kernel) streams a query's part lists
// through the same selection and turns the final keys into (score, id).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace scan_topk {

typedef unsigned long long Key;

constexpr int kThreads = 256;
constexpr int kTile = 1024;            // rows (or keys) offered per tile
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

  __device__ __forceinline__ void offer(Key key) {
    if (key < thr) buf[atomicAdd(cnt, 1)] = key;
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

// Result id of a list-major scan: position p * max_len + slot of query qi
// is slot `slot` of its p-th probed list.
struct ListIds {
  const int* probe;
  const int* member_ids;
  int n_probe, max_len;
  __device__ int operator()(int qi, unsigned pos) const {
    const int p = static_cast<int>(pos / max_len);
    const int slot = static_cast<int>(pos % max_len);
    const int lst = probe[static_cast<size_t>(qi) * n_probe + p];
    return member_ids[static_cast<size_t>(lst) * max_len + slot];
  }
};

// Pass 2: one block per query merges its n_in part keys into the top-k.
template <class IdOf>
__global__ void __launch_bounds__(kThreads)
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
  for (int t0 = 0; t0 < n_in; t0 += kTile) {
    const int tn = min(kTile, n_in - t0);
    sel.reserve(tn);
    for (int r = t0 + threadIdx.x; r < t0 + tn; r += blockDim.x)
      sel.offer(in[r]);
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

// Write a part's selected keys (padded with kEmpty to kp).
__device__ __forceinline__ void write_part(const Key* buf, int n, Key* out,
                                           int kp) {
  for (int r = threadIdx.x; r < kp; r += blockDim.x)
    out[r] = r < n ? buf[r] : kEmpty;
}

template <class IdOf>
cudaError_t launch_merge(const Key* part, int nq, int n_in, int k,
                         float* out_s, int* out_i, IdOf id_of,
                         cudaStream_t st) {
  const int cap = buffer_cap(k);
  const size_t smem = sizeof(Key) * cap + 16;
  cudaError_t err = cudaFuncSetAttribute(
      merge_kernel<IdOf>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  merge_kernel<IdOf><<<nq, kThreads, smem, st>>>(part, n_in, k, cap, out_s,
                                                 out_i, id_of);
  return cudaGetLastError();
}

}  // namespace scan_topk
