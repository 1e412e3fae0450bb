// Sorted segment sum over a CSR row pointer, for Hopper (sm_90a).
//
// Replaces the TPU kernel `sorted_segment_sum` of the JAX package
// (src/repro/kernels/segment_sum.py): the message-passing scatter of a GNN,
// with the messages sorted by receiver so that segment i owns the rows
// [indptr[i], indptr[i+1]) of the data.  out (N, D) float32 = the sum of
// each segment's rows; an empty segment is 0; rows past indptr[N] (padded
// edges) are never read.
//
// Bound on an H100 SXM: bytes.  The rows are read once and the (N, D)
// result written once: at EGNN's ogbn-products message sum (61.9M x 64
// float32 messages onto 2.45M nodes) 15.8 GB read and 0.63 GB written,
// 4.9 ms at 3.35 TB/s; the adds are one per element read.
//
// Design.  The TPU kernel reduces each block of nodes with a one-hot
// matmul on the MXU because the TPU has no fast scatter; on the GPU that
// would spend block_n times the additions of the sum, so it is not carried
// over.  Here one warp owns one segment: its lanes form R = 32 / G row
// groups of G lanes, G lanes covering a row with 16-byte loads where the
// row allows (D = 64: 16 lanes a row, two rows per step), and walk the
// segment's contiguous row range four steps at a time with float32
// register accumulators; a shuffle butterfly then adds the R partial sums.
// No atomics, and a fixed order of additions for a given indptr, so the
// result is deterministic.  The accumulation is compensated: every add is
// an error-free TwoSum whose rounding error goes to a second register
// (cascaded summation, Ogita-Rump-Oishi Sum2), and the butterfly merges
// (sum, error) pairs the same way, so a segment's result is as accurate
// as a float64 sum rounded once.  Plain float32 accumulation lost up to
// 1.7e-4 of a segment's sum of |x| on EGNN's ogbn-products messages,
// where tens of thousands of small terms meet one large one (a sum that
// large rounds each small term away); the extra adds cost nothing here, as
// the kernel waits on memory.  A power-law graph gives a few warps most of
// the rows (hubs of 20,000-30,000 in-edges against a mean of 25): this
// first kernel does not split them.  indptr is clamped to [0, n_rows], so a
// wrong pointer cannot read outside the data.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// s + e == a + b exactly (Knuth's TwoSum; no multiply, so nothing for the
// compiler to contract, and no reassociation without fast-math).
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  const float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

template <int VW>
__device__ __forceinline__ void load_row(const float* p, float* v) {
  if constexpr (VW == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VW>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ data,
                   const int* __restrict__ indptr, float* __restrict__ out,
                   int n_seg, int n_rows, int d, long long ld, int group) {
  const long long seg = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (seg >= n_seg) return;                  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int r = lane / group, col = lane % group, rows = 32 / group;
  const int e0 = min(max(__ldg(indptr + seg), 0), n_rows);
  const int e1 = min(max(__ldg(indptr + seg + 1), e0), n_rows);
  const int n_vec = d / VW;
  float* orow = out + seg * d;

  for (int c0 = 0; c0 < n_vec; c0 += group) {   // uniform across the warp
    const int c = c0 + col;
    float acc[VW], err[VW];                   // running sum, its lost part
#pragma unroll
    for (int v = 0; v < VW; ++v) acc[v] = err[v] = 0.f;
    if (c < n_vec) {
      const float* base = data + (long long)c * VW;
      int e = e0 + r;
      for (; e + 3 * rows < e1; e += 4 * rows) {
        float x[4][VW];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          load_row<VW>(base + (long long)(e + j * rows) * ld, x[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int v = 0; v < VW; ++v) {
            float lost;
            two_sum(acc[v], x[j][v], acc[v], lost);
            err[v] += lost;
          }
      }
      for (; e < e1; e += rows) {
        float x[VW];
        load_row<VW>(base + (long long)e * ld, x);
#pragma unroll
        for (int v = 0; v < VW; ++v) {
          float lost;
          two_sum(acc[v], x[v], acc[v], lost);
          err[v] += lost;
        }
      }
    }
    // both lanes of a pair compute the same pair sum (TwoSum's error is
    // exact whatever the order), so every lane ends with the same value
    for (int off = group; off < 32; off <<= 1)
#pragma unroll
      for (int v = 0; v < VW; ++v) {
        const float s2 = __shfl_xor_sync(0xffffffffu, acc[v], off);
        const float e2 = __shfl_xor_sync(0xffffffffu, err[v], off);
        float lost;
        two_sum(acc[v], s2, acc[v], lost);
        err[v] = (err[v] + e2) + lost;
      }
    float res[VW];
#pragma unroll
    for (int v = 0; v < VW; ++v)      // an infinite sum has no lost part
      res[v] = isfinite(acc[v]) ? acc[v] + err[v] : acc[v];
    if (r == 0 && c < n_vec) {
      if constexpr (VW == 4) {
        *reinterpret_cast<float4*>(orow + c * 4) =
            make_float4(res[0], res[1], res[2], res[3]);
      } else {
        orow[c] = res[0];
      }
    }
  }
}

template <int VW>
cudaError_t launch(const float* data, const int* indptr, float* out,
                   int n_seg, int n_rows, int d, long long ld,
                   cudaStream_t st) {
  const int n_vec = d / VW;
  int group = 1;
  while (group < n_vec && group < 32) group <<= 1;
  const long long blocks = ((long long)n_seg * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  segment_sum_kernel<VW><<<(unsigned)blocks, kThreads, 0, st>>>(
      data, indptr, out, n_seg, n_rows, d, ld, group);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// data: (n_rows, d) float32, unit stride on d, row stride ld elements,
// sorted by segment; indptr: (n_seg + 1,) int32 row pointers; out: (n_seg,
// d) float32 contiguous.  vec != 0 selects 16-byte loads (d and ld
// multiples of 4, data 16-byte aligned).  Returns the launch's CUDA error.
int segment_sum_launch(const float* data, const int* indptr, float* out,
                       int n_seg, int n_rows, int d, long long ld, int vec,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = vec ? launch<4>(data, indptr, out, n_seg, n_rows, d, ld, st)
                        : launch<1>(data, indptr, out, n_seg, n_rows, d, ld, st);
  return (int)err;
}

// Human-readable name of a CUDA error code returned by the launcher.
const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
