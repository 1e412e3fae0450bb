// PQ ADC stage-0 scans, flat and list-major, for Hopper (sm_90a).
//
// Replaces the TPU kernels `pq_scan_topk` and `pq_ivf_scan_topk` of the JAX
// package (src/repro/kernels/pq_scan.py: :130 -> `_pq_scan_call` :97 and
// :224 -> `_pq_ivf_call` :175, both around the body `_pq_body` :51).  A
// row's score is sum_m lut[m, code[m]] over its M uint8 codes, summed in m
// order; ids of -1 (padding, tombstones, rows past the coded prefix) are
// never returned; the k best are kept per query.  The TPU body looks the
// table up as a one-hot matrix product (its VMEM has no fast gather); here
// the (M, C) table of a query sits in shared memory and each code indexes
// it directly.
//
// Bound on an H100 SXM: the codes and ids read once — 20 B a row at M = 16,
// 21 MB for the flat scan of 1M rows (6 us at 3.35 TB/s) and at most 4 MB
// for the list-major scan at Q=32, n_probe 12, max_len 512.  This design gives
// every query its own blocks, so the flat scan reads the code block once
// per query (after the first, mostly from L2: 16 MB fits in its 50 MB) and
// does Q * N * M shared-memory lookups; those set its time, not device
// memory.  Sharing one code read among several queries' tables is the next
// step.
//
// Design.  One scoring body (pq_part_kernel) serves both entry points, as
// both Pallas calls share `_pq_body`.  Pass 1 runs one block per (part of
// the rows, query): a contiguous range of rows for the flat scan, one
// probed list's slab for the list-major scan.  The block copies its
// query's table into shared memory, each thread scores one row at a time
// from a 16-byte (or 4-byte) load of its codes, and the block keeps the
// part's top-k with the streaming selection of scan_topk.cuh (keys ordered
// by score, then scan position: the row index of the flat scan, probe
// rank * max_len + slot of the list-major one).  Pass 2 merges each
// query's part lists.

#include "scan_topk.cuh"

namespace {

using scan_topk::Key;
using scan_topk::kThreads;
using scan_topk::kTile;

// sum_m lut_s[m * c + code[m]], in m order.  vec is 16, 4 or 1: the width
// of the loads of a row's codes (alignment and m permitting).
__device__ __forceinline__ float adc(const float* lut_s,
                                     const uint8_t* __restrict__ code, int m,
                                     int c, int vec) {
  float s = 0.f;
  if (vec == 16) {
    const uint4* w = reinterpret_cast<const uint4*>(code);
    for (int g = 0; g < m / 16; ++g) {
      const uint4 v = __ldg(w + g);
      const unsigned word[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int h = 0; h < 4; ++h)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          s += lut_s[(g * 16 + h * 4 + b) * c + ((word[h] >> (8 * b)) & 0xff)];
    }
  } else if (vec == 4) {
    const unsigned* w = reinterpret_cast<const unsigned*>(code);
    for (int g = 0; g < m / 4; ++g) {
      const unsigned v = __ldg(w + g);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        s += lut_s[(g * 4 + b) * c + ((v >> (8 * b)) & 0xff)];
    }
  } else {
    for (int j = 0; j < m; ++j) s += lut_s[j * c + __ldg(code + j)];
  }
  return s;
}

// LIST: part = probed list (rows of slab probe[qi, part], scan positions
// part * rows_per + slot); else part = row range [part * rows_per, ...) of
// n_rows (scan position = row).  ids: the id of every row, -1 = skip.
template <bool LIST>
__global__ void __launch_bounds__(kThreads)
pq_part_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
               const int* __restrict__ ids, const int* __restrict__ probe,
               Key* __restrict__ part, int n_rows, int rows_per, int n_parts,
               int m, int c, int k, int kp, int cap, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  Key* buf = reinterpret_cast<Key*>(smem);
  float* lut_s = reinterpret_cast<float*>(buf + cap);
  int* cnt = reinterpret_cast<int*>(lut_s + m * c);
  const int pi = blockIdx.x;
  const int qi = blockIdx.y;

  const float* lq = lut + static_cast<size_t>(qi) * m * c;
  for (int i = threadIdx.x; i < m * c; i += blockDim.x) lut_s[i] = lq[i];
  scan_topk::Selector sel;
  sel.init(buf, cnt, cap, k);
  __syncthreads();

  size_t row0;
  int nr;
  unsigned pos0;
  if (LIST) {
    row0 = static_cast<size_t>(probe[static_cast<size_t>(qi) * n_parts + pi]) *
           rows_per;
    nr = rows_per;
    pos0 = static_cast<unsigned>(pi) * rows_per;
  } else {
    row0 = static_cast<size_t>(pi) * rows_per;
    nr = min(rows_per, n_rows - static_cast<int>(row0));
    pos0 = static_cast<unsigned>(row0);
  }
  for (int t0 = 0; t0 < nr; t0 += kTile) {
    const int tn = min(kTile, nr - t0);
    sel.reserve(tn);
    for (int r = t0 + threadIdx.x; r < t0 + tn; r += blockDim.x) {
      if (ids[row0 + r] < 0) continue;
      const float s = adc(lut_s, codes + (row0 + r) * m, m, c, vec);
      if (isfinite(s)) sel.offer(scan_topk::make_key(s, pos0 + r));
    }
    __syncthreads();
  }
  const int n = sel.finish();
  scan_topk::write_part(buf, n,
                        part + (static_cast<size_t>(qi) * n_parts + pi) * kp,
                        kp);
}

template <bool LIST>
cudaError_t launch_parts(const float* lut, const uint8_t* codes,
                         const int* ids, const int* probe, Key* part, int nq,
                         int n_rows, int rows_per, int n_parts, int m, int c,
                         int k, int kp, cudaStream_t st) {
  const int cap = scan_topk::buffer_cap(k);
  const size_t smem = sizeof(Key) * cap + sizeof(float) * m * c + 16;
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
  const int vec = (m % 16 == 0 && base % 16 == 0)  ? 16
                  : (m % 4 == 0 && base % 4 == 0) ? 4
                                                  : 1;
  cudaError_t err = cudaFuncSetAttribute(
      pq_part_kernel<LIST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  pq_part_kernel<LIST><<<dim3(n_parts, nq), kThreads, smem, st>>>(
      lut, codes, ids, probe, part, n_rows, rows_per, n_parts, m, c, k, kp,
      cap, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Flat scan.  lut (nq, m, c) float32; codes (n, m) uint8; ids (n,) int32,
// -1 = unreturnable; the rows split into n_split ranges of rows_per;
// part (nq, n_split, kp) 64-bit scratch, kp = min(k, rows_per); out
// (nq, k).  Returns the first CUDA error of the two launches.
int pq_scan_topk_launch(const float* lut, const uint8_t* codes,
                        const int* ids, unsigned long long* part,
                        float* out_s, int* out_i, int nq, int n, int m, int c,
                        int n_split, int rows_per, int k, int kp,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_parts<false>(lut, codes, ids, nullptr, part, nq, n,
                                        rows_per, n_split, m, c, k, kp, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(scan_topk::launch_merge(
      part, nq, n_split * kp, k, out_s, out_i, scan_topk::FlatIds{ids}, st));
}

// List-major scan.  lut (nq, m, c) float32; codes (n_lists * max_len, m)
// uint8 list-major slabs; member_ids (n_lists, max_len) int32, -1 =
// unreturnable; probe (nq, n_probe) int32 distinct list indices; part (nq,
// n_probe, kp) 64-bit scratch, kp = min(k, max_len); out (nq, k).
int pq_ivf_scan_topk_launch(const float* lut, const uint8_t* codes,
                            const int* member_ids, const int* probe,
                            unsigned long long* part, float* out_s,
                            int* out_i, int nq, int n_probe, int max_len,
                            int m, int c, int k, int kp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_parts<true>(lut, codes, member_ids, probe, part,
                                       nq, 0, max_len, n_probe, m, c, k, kp,
                                       st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(scan_topk::launch_merge(
      part, nq, n_probe * kp, k, out_s, out_i,
      scan_topk::ListIds{probe, member_ids, n_probe, max_len}, st));
}

// Human-readable name of a CUDA error code returned by the launchers.
const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
