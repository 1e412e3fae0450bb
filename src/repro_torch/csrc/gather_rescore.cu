// Candidate gather + rescore with fused top-k, for Hopper (sm_90a).
//
// Replaces the TPU kernel `gather_rescore` of the JAX package
// (src/repro/kernels/gather_rescore.py) and the top-k its callers run on
// its output: one step of progressive search's rescore ladder.  Each query
// scores its own C candidate rows over their [:dim] prefix and keeps the
// best k, without building the (Q, C, dim) gathered tensor.
//
// Bound on an H100 SXM: the bytes are Q*C*(4*dim + 9) (rows, prefix norm,
// validity byte, id) plus the queries — about 2 MB per ladder step at the
// serving shapes (32 queries; (C, dim) from (64, 256) to (10, 3584)), under
// a microsecond at 3.35 TB/s.  A step is therefore bound by launch latency
// and by the dependent chain gather -> reduce -> select inside one block,
// not by bytes or operations.
//
// Design.  One block per query (the TPU grid's one step per query).  Each
// warp takes candidates in turn and streams its row with 16-byte loads,
// reducing the dot product (and the row norm when no prefix norm is given)
// across the warp with shuffles; the C scores sit in shared memory.  The
// top-k is then a rank count: candidate c's rank is the number of
// candidates ordered before it by (score, position in cand), an exact,
// deterministic selection with the plain version's tie rule, and cheap for
// the ladder's C of at most a few hundred.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool VEC, bool HAS_SQ>
__global__ void __launch_bounds__(kThreads)
gather_rescore_topk_kernel(const float* __restrict__ q,
                           const float* __restrict__ db,
                           const int* __restrict__ cand,
                           const float* __restrict__ sq,
                           const uint8_t* __restrict__ valid,
                           float* __restrict__ out_s, int* __restrict__ out_i,
                           int n, int ld_q, int ld_db, int c, int dim, int k) {
  extern __shared__ __align__(16) float sc[];      // [c] scores
  const int qi = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const float* qrow = q + (size_t)qi * ld_q;
  const int* crow = cand + (size_t)qi * c;

  for (int cc = warp; cc < c; cc += n_warps) {
    const int id = crow[cc];
    float s = CUDART_INF_F;
    if (id >= 0 && id < n && (valid == nullptr || valid[id] != 0)) {
      const float* row = db + (size_t)id * ld_db;
      float dot = 0.f, nrm = 0.f;
      if (VEC) {
        const float4* r4 = reinterpret_cast<const float4*>(row);
        const float4* q4 = reinterpret_cast<const float4*>(qrow);
#pragma unroll 4
        for (int d = lane; d < dim / 4; d += 32) {
          const float4 x = __ldg(r4 + d);
          const float4 y = __ldg(q4 + d);
          dot = fmaf(x.x, y.x, dot);
          dot = fmaf(x.y, y.y, dot);
          dot = fmaf(x.z, y.z, dot);
          dot = fmaf(x.w, y.w, dot);
          if (!HAS_SQ) {
            nrm = fmaf(x.x, x.x, nrm);
            nrm = fmaf(x.y, x.y, nrm);
            nrm = fmaf(x.z, x.z, nrm);
            nrm = fmaf(x.w, x.w, nrm);
          }
        }
      } else {
#pragma unroll 4
        for (int d = lane; d < dim; d += 32) {
          const float x = __ldg(row + d);
          dot = fmaf(x, __ldg(qrow + d), dot);
          if (!HAS_SQ) nrm = fmaf(x, x, nrm);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (!HAS_SQ) nrm += __shfl_xor_sync(0xffffffffu, nrm, off);
      }
      s = (HAS_SQ ? __ldg(sq + id) : nrm) - 2.0f * dot;
      if (!(s == s)) s = CUDART_INF_F;             // NaN ranks last
    }
    if (lane == 0) sc[cc] = s;
  }
  __syncthreads();

  for (int cc = threadIdx.x; cc < c; cc += blockDim.x) {
    const float s = sc[cc];
    int rank = 0;
    for (int j = 0; j < c; ++j) {
      const float t = sc[j];
      rank += (t < s) || (t == s && j < cc);
    }
    if (rank < k) {
      out_s[(size_t)qi * k + rank] = s;
      out_i[(size_t)qi * k + rank] = s < CUDART_INF_F ? crow[cc] : -1;
    }
  }
}

template <bool VEC, bool HAS_SQ>
cudaError_t launch(const float* q, const float* db, const int* cand,
                   const float* sq, const uint8_t* valid, float* out_s,
                   int* out_i, int nq, int n, int ld_q, int ld_db, int c,
                   int dim, int k, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)c;
  auto kern = gather_rescore_topk_kernel<VEC, HAS_SQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<nq, kThreads, smem, st>>>(q, db, cand, sq, valid, out_s, out_i, n,
                                   ld_q, ld_db, c, dim, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (nq, ld_q) and db (n, ld_db) float32 row-major; cand (nq, c) int32 row
// ids, -1 = padding; sq (n,) float32 prefix norms at `dim` or null (computed
// from the gathered rows); valid (n,) bytes or null (all rows valid);
// out (nq, k).  vec != 0 selects 16-byte loads (dim, ld_q, ld_db multiples
// of 4, pointers 16-byte aligned).  Returns the launch's CUDA error.
int gather_rescore_topk_launch(const float* q, const float* db,
                               const int* cand, const float* sq,
                               const uint8_t* valid, float* out_s, int* out_i,
                               int nq, int n, int ld_q, int ld_db, int c,
                               int dim, int k, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec && sq)
    err = launch<true, true>(q, db, cand, sq, valid, out_s, out_i, nq, n, ld_q,
                             ld_db, c, dim, k, st);
  else if (vec)
    err = launch<true, false>(q, db, cand, sq, valid, out_s, out_i, nq, n,
                              ld_q, ld_db, c, dim, k, st);
  else if (sq)
    err = launch<false, true>(q, db, cand, sq, valid, out_s, out_i, nq, n,
                              ld_q, ld_db, c, dim, k, st);
  else
    err = launch<false, false>(q, db, cand, sq, valid, out_s, out_i, nq, n,
                               ld_q, ld_db, c, dim, k, st);
  return (int)err;
}

// Human-readable name of a CUDA error code returned by the launcher.
const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
