// EmbeddingBag over stacked per-field tables, for Hopper (sm_90a).
//
// Replaces the TPU kernel `embedding_bag` of the JAX package
// (src/repro/kernels/embedding_bag.py: gather + per-bag sum / mean, -1 =
// padding, float32 accumulation).  One launch covers every field of a
// stacked (F, V, D) table: ids (B, F, L) -> (B, F, D) float32, written
// contiguously so the towers' (B, F*D) reshape costs no copy.
//
// Bound on an H100 SXM: bytes.  Each bag reads its L rows (D elements
// each) and writes one float32 row; there is no arithmetic to speak of.
// At the two-tower item build (4 fields x 1M bags of one 1 KiB row) that is
// 8.2 GB, 2.45 ms at 3.35 TB/s.
//
// Design.  The TPU kernel walks bags one after another per grid step with
// a double-buffered row DMA; here every (bag, field) pair gets a group of
// G lanes (G = the row's 16-byte vectors, at most 32, a power of two, so a
// group never straddles a warp) and each lane owns a column slice of the
// row: neighbouring lanes read neighbouring 16-byte words of one row, and
// thousands of groups keep enough row reads in flight to cover the
// latency of the random gathers.  Within a bag, ids are taken four at a
// time and their rows loaded before they are added, in id order, to
// float32 registers — the order of the plain version, so the two agree
// bit for bit.  A negative id is padding and is skipped; an id >= V
// reads row V - 1, as the JAX package's clamped gather does, so no id
// reads outside the table.  `mean` divides by max(count of valid ids, 1):
// an all-padding bag gives 0.  Tables are float32 or bfloat16 (template).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Add VW consecutive elements at p to acc (VW = 1, or one 16-byte word).
template <typename T, int VW>
struct Row;

template <>
struct Row<float, 1> {
  __device__ static void load(const float* p, float* v) { v[0] = __ldg(p); }
};
template <>
struct Row<float, 4> {
  __device__ static void load(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};
template <>
struct Row<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(p[0]);
  }
};
template <>
struct Row<__nv_bfloat16, 8> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <typename T, int VW>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ tab, const int* __restrict__ ids,
                     float* __restrict__ out, long long n_bags, int n_fields,
                     int bag_len, int vocab, int d, long long ld_field,
                     long long ld_row, int group, int mean) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long bag = t / group;
  const int lane = (int)(t % group);
  if (bag >= n_bags) return;
  const int* bag_ids = ids + bag * bag_len;
  const T* base = tab + (long long)(bag % n_fields) * ld_field;
  float* orow = out + bag * d;

  int cnt = 0;
  for (int l = 0; l < bag_len; ++l) cnt += __ldg(bag_ids + l) >= 0;
  const float denom = mean ? (float)(cnt > 1 ? cnt : 1) : 1.f;

  const int n_vec = d / VW;
  for (int c = lane; c < n_vec; c += group) {
    const T* col = base + (long long)c * VW;
    float acc[VW];
#pragma unroll
    for (int v = 0; v < VW; ++v) acc[v] = 0.f;
    int l = 0;
    for (; l + 4 <= bag_len; l += 4) {
      int id[4];
      float x[4][VW];
#pragma unroll
      for (int j = 0; j < 4; ++j) id[j] = __ldg(bag_ids + l + j);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (id[j] >= 0)
          Row<T, VW>::load(col + (long long)min(id[j], vocab - 1) * ld_row,
                           x[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (id[j] >= 0) {
#pragma unroll
          for (int v = 0; v < VW; ++v) acc[v] += x[j][v];
        }
    }
    for (; l < bag_len; ++l) {
      const int id = __ldg(bag_ids + l);
      if (id < 0) continue;
      float x[VW];
      Row<T, VW>::load(col + (long long)min(id, vocab - 1) * ld_row, x);
#pragma unroll
      for (int v = 0; v < VW; ++v) acc[v] += x[v];
    }
    float* o = orow + (long long)c * VW;
    if constexpr (VW % 4 == 0) {
#pragma unroll
      for (int v = 0; v < VW; v += 4)
        *reinterpret_cast<float4*>(o + v) =
            make_float4(acc[v] / denom, acc[v + 1] / denom,
                        acc[v + 2] / denom, acc[v + 3] / denom);
    } else {
#pragma unroll
      for (int v = 0; v < VW; ++v) o[v] = acc[v] / denom;
    }
  }
}

template <typename T, int VW>
cudaError_t launch(const void* tab, const int* ids, float* out,
                   long long n_bags, int n_fields, int bag_len, int vocab,
                   int d, long long ld_field, long long ld_row, int mean,
                   cudaStream_t st) {
  const int n_vec = d / VW;
  int group = 1;
  while (group < n_vec && group < 32) group <<= 1;
  const long long threads = n_bags * group;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  embedding_bag_kernel<T, VW><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(tab), ids, out, n_bags, n_fields, bag_len, vocab,
      d, ld_field, ld_row, group, mean);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// tab: (n_fields, vocab, d) float32 (bf16 == 0) or bfloat16 (bf16 != 0),
// unit stride on d, strides ld_field / ld_row in elements; ids: (n_bags,
// bag_len) int32 contiguous, bag b of field b % n_fields (the (B, F, L)
// layout flattened); out: (n_bags, d) float32 contiguous.  vec != 0 selects
// 16-byte loads (d and both strides multiples of 16 bytes, table 16-byte
// aligned).  mean != 0 divides by max(valid ids, 1).  Returns the launch's
// CUDA error.
int embedding_bag_launch(const void* tab, const int* ids, float* out,
                         long long n_bags, int n_fields, int bag_len,
                         int vocab, int d, long long ld_field,
                         long long ld_row, int mean, int bf16, int vec,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16 && vec)
    err = launch<__nv_bfloat16, 8>(tab, ids, out, n_bags, n_fields, bag_len,
                                   vocab, d, ld_field, ld_row, mean, st);
  else if (bf16)
    err = launch<__nv_bfloat16, 1>(tab, ids, out, n_bags, n_fields, bag_len,
                                   vocab, d, ld_field, ld_row, mean, st);
  else if (vec)
    err = launch<float, 4>(tab, ids, out, n_bags, n_fields, bag_len, vocab, d,
                           ld_field, ld_row, mean, st);
  else
    err = launch<float, 1>(tab, ids, out, n_bags, n_fields, bag_len, vocab, d,
                           ld_field, ld_row, mean, st);
  return (int)err;
}

// Human-readable name of a CUDA error code returned by the launcher.
const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
