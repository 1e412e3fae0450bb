// IVF stage 0 over list-major member slabs, for Hopper (sm_90a).
//
// Replaces the TPU kernel `ivf_scan_topk` of the JAX package
// (src/repro/kernels/ivf_scan.py: wrapper :275, `_ivf_scan_call` :227,
// body `_kernel` :182).  For each query, the members of its n_probe probed
// lists are scored `sq - 2 q.x` at the stage-0 dim and the k best kept;
// ids of -1 (list padding, tombstones) are never returned.  Member rows are
// float32 or per-dimension int8 codes; for int8 the caller folds the query
// onto the codes' grid, and the kernel widens each code to float and
// accumulates in float32.  (The TPU kernel multiplies the int8 rows as
// bfloat16 at the MXU's default precision; the results the port is held to
// are the JAX package's CPU / interpret ones, which are float32
// throughout — as this kernel is.)
//
// Bound on an H100 SXM: the bytes of the probed slabs.  At the serving
// shape (Q=32, n_probe 12, max_len 512, dim 128) that is 32*12*512 rows of
// 512 B (f32) or 128 B (int8) plus 8 B of norm and id each — 102 MB or
// 27 MB, 30 us or 8 us at 3.35 TB/s.  Queries probe different lists, so
// no row read is shared between them.
//
// Design.  The TPU grid walks (query x probe x chunk) in order and carries
// the top-k in VMEM; a Hopper grid has no order.  Pass 1 runs one block per
// (probed list, query): each warp takes member rows in turn, reads a row
// with 16-byte (f32) or 4-byte (int8) loads across its lanes and reduces
// the dot product with shuffles, and the block keeps its list's top-k with
// the streaming selection of scan_topk.cuh (keys ordered by score, then
// scan position p * max_len + slot, so ties break as lax.top_k breaks them
// over the probed-list table).  Pass 2 merges the n_probe lists of each
// query.

#include "scan_topk.cuh"

namespace {

using scan_topk::Key;
using scan_topk::kThreads;
using scan_topk::kTile;

template <typename T, bool VEC>
__device__ __forceinline__ float row_dot(const T* __restrict__ x,
                                         const float* qs, int dim, int lane) {
  float acc = 0.f;
  if constexpr (VEC) {
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    for (int d = lane; d < (dim >> 2); d += 32) {
      const float4 b = q4[d];
      float a0, a1, a2, a3;
      if constexpr (sizeof(T) == 4) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(x) + d);
        a0 = a.x; a1 = a.y; a2 = a.z; a3 = a.w;
      } else {
        const char4 a = __ldg(reinterpret_cast<const char4*>(x) + d);
        a0 = a.x; a1 = a.y; a2 = a.z; a3 = a.w;
      }
      acc = fmaf(a0, b.x, acc);
      acc = fmaf(a1, b.y, acc);
      acc = fmaf(a2, b.z, acc);
      acc = fmaf(a3, b.w, acc);
    }
  } else {
    for (int d = lane; d < dim; d += 32)
      acc = fmaf(static_cast<float>(x[d]), qs[d], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
ivf_list_kernel(const float* __restrict__ q, const int* __restrict__ probe,
                const T* __restrict__ rows, const float* __restrict__ sq,
                const int* __restrict__ member_ids, Key* __restrict__ part,
                int n_probe, int max_len, int dim, int k, int kp, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  Key* buf = reinterpret_cast<Key*>(smem);
  float* qs = reinterpret_cast<float*>(buf + cap);
  int* cnt = reinterpret_cast<int*>(qs + ((dim + 3) & ~3));
  const int p = blockIdx.x;
  const int qi = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int d = threadIdx.x; d < dim; d += blockDim.x)
    qs[d] = q[static_cast<size_t>(qi) * dim + d];
  scan_topk::Selector sel;
  sel.init(buf, cnt, cap, k);
  __syncthreads();

  const size_t row0 =
      static_cast<size_t>(probe[static_cast<size_t>(qi) * n_probe + p]) *
      max_len;
  for (int t0 = 0; t0 < max_len; t0 += kTile) {
    const int tn = min(kTile, max_len - t0);
    sel.reserve(tn);
    for (int r = t0 + warp; r < t0 + tn; r += n_warps) {
      if (member_ids[row0 + r] < 0) continue;          // padding, tombstone
      const float dot =
          row_dot<T, VEC>(rows + (row0 + r) * dim, qs, dim, lane);
      if (lane == 0) {
        const float s = sq[row0 + r] - 2.f * dot;
        if (isfinite(s))
          sel.offer(scan_topk::make_key(
              s, static_cast<unsigned>(p) * max_len + r));
      }
    }
    __syncthreads();
  }
  const int n = sel.finish();
  scan_topk::write_part(buf, n,
                        part + (static_cast<size_t>(qi) * n_probe + p) * kp,
                        kp);
}

template <typename T, bool VEC>
cudaError_t launch_lists(const float* q, const int* probe, const void* rows,
                         const float* sq, const int* member_ids, Key* part,
                         int nq, int n_probe, int max_len, int dim, int k,
                         int kp, cudaStream_t st) {
  const int cap = scan_topk::buffer_cap(k);
  const size_t smem =
      sizeof(Key) * cap + sizeof(float) * ((dim + 3) & ~3) + 16;
  auto kern = ivf_list_kernel<T, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<dim3(n_probe, nq), kThreads, smem, st>>>(
      q, probe, static_cast<const T*>(rows), sq, member_ids, part, n_probe,
      max_len, dim, k, kp, cap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (nq, dim) float32 (int8 slabs: already folded onto the codes' grid);
// probe (nq, n_probe) int32 distinct list indices; rows (n_lists * max_len,
// dim) float32 or int8 (is_int8); sq (n_lists, max_len) float32 norms;
// member_ids (n_lists, max_len) int32, -1 = unreturnable; part (nq,
// n_probe, kp) 64-bit scratch, kp = min(k, max_len); out (nq, k).  Returns
// the first CUDA error of the two launches.
int ivf_scan_topk_launch(const float* q, const int* probe, const void* rows,
                         const float* sq, const int* member_ids,
                         unsigned long long* part, float* out_s, int* out_i,
                         int nq, int n_probe, int max_len, int dim, int k,
                         int kp, int is_int8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t base = reinterpret_cast<uintptr_t>(rows);
  cudaError_t err;
  if (is_int8) {
    const bool vec = dim % 4 == 0 && base % 4 == 0;
    err = vec ? launch_lists<int8_t, true>(q, probe, rows, sq, member_ids,
                                           part, nq, n_probe, max_len, dim,
                                           k, kp, st)
              : launch_lists<int8_t, false>(q, probe, rows, sq, member_ids,
                                            part, nq, n_probe, max_len, dim,
                                            k, kp, st);
  } else {
    const bool vec = dim % 4 == 0 && base % 16 == 0;
    err = vec ? launch_lists<float, true>(q, probe, rows, sq, member_ids,
                                          part, nq, n_probe, max_len, dim, k,
                                          kp, st)
              : launch_lists<float, false>(q, probe, rows, sq, member_ids,
                                           part, nq, n_probe, max_len, dim,
                                           k, kp, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(scan_topk::launch_merge(
      part, nq, n_probe * kp, k, out_s, out_i,
      scan_topk::ListIds{probe, member_ids, n_probe, max_len}, st));
}

// Human-readable name of a CUDA error code returned by the launcher.
const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
