// Fused online-softmax attention (GQA, causal / sliding window aligned to
// the end of kv), for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention` of the JAX package
// (src/repro/kernels/flash_attention.py: wrapper :108, body `_kernel` :38).
// It computes what `_kernel` computes, for every prefill and decode layer
// of the LM:
//
//   offset = skv - sq; query row i sits at absolute position i + offset;
//   a key at k_pos is kept when k_pos < skv, k_pos <= q_pos (causal) and
//   k_pos > q_pos - window (window given); masked scores are -1e30;
//   per kv tile: m_new = max(m, rowmax(s)), p = mask ? exp(s - m_new) : 0,
//   l = l * exp(m - m_new) + rowsum(p), acc = acc * exp(m - m_new) + p'V
//   where p' is p rounded to v's type; out = acc / max(l, 1e-30) in q's
//   type.  The running max, sum and accumulator are float32.  A row with
//   nothing to attend gives 0.
//
// Bound on an H100 SXM, at the serving shapes of Mistral-Nemo-12B (bf16,
// batch 8, 32 q heads on 8 kv heads, d_head 128): prefill over a 512-token
// prompt moves 84 MB (q, k, v, out) for 17 GFLOP of causal products —
// 25 us of bytes against 17 us of bf16 tensor-core work, so bytes bound
// it; decode reads the K and V cache prefix (18 MB at 544 positions) for
// almost no arithmetic — 5.3 us.
//
// Design (a simple first version; tensor cores, TMA and split-kv decode are
// later work).  GQA without a copy: one block serves one (batch, kv head,
// q tile) and all Hq/Hkv q heads of the group, so each K/V tile is loaded
// once for the group.  The block's 64 rows are (q position, head) pairs,
// position-major, so a decode step (one position) has its Hq/Hkv rows at
// the front.  Per kv tile of 64 keys: K and V are read with 16-byte loads
// into shared memory as float32, the 64x64 scores are float32 FMA dot
// products (4x4 register blocks when all rows are live), a warp per row
// updates the running max and sum and writes the rounded p, and each thread
// accumulates its rows x 4 dims of p'V in registers.  Tiles above the
// causal diagonal or left of the window are never visited, as the TPU
// kernel skips them.  K and V are taken by strides, so the decode cache
// prefix k_cache[:, :, :pos + 1] is read in place.  Known limit: decode at
// batch 8 with 8 kv heads runs 64 blocks on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;        // (q position, head) rows per block
constexpr int kBK = 64;          // keys per kv tile
constexpr int kPStr = kBK + 4;   // row stride of the score tile (floats)
constexpr float kMasked = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// `n` elements of T from global memory into floats in shared memory; with
// VEC, 16-byte loads (n a multiple of 16 / sizeof(T), src 16-byte aligned).
template <typename T, bool VEC>
__device__ __forceinline__ void load_row_chunk(const T* __restrict__ src,
                                               float* dst) {
  if constexpr (VEC) {
    constexpr int kE = 16 / sizeof(T);
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int t = 0; t < kE; t += 4)
      *reinterpret_cast<float4*>(dst + t) =
          make_float4(to_f<T>(e[t]), to_f<T>(e[t + 1]), to_f<T>(e[t + 2]),
                      to_f<T>(e[t + 3]));
  } else {
    *dst = to_f<T>(src[0]);
  }
}

// rows x DH elements (row r at src + row_off(r)) into dst[r * stride + d];
// rows at or beyond `n_live` are zero-filled.
template <typename T, bool VEC, int DH, typename RowOff>
__device__ __forceinline__ void load_tile(float* dst, int stride, int rows,
                                          int n_live, const T* __restrict__ base,
                                          RowOff row_off) {
  constexpr int kE = VEC ? 16 / sizeof(T) : 1;
  constexpr int kPerRow = DH / kE;
  for (int idx = threadIdx.x; idx < rows * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int d = (idx % kPerRow) * kE;
    float* out = dst + r * stride + d;
    if (r < n_live) {
      load_row_chunk<T, VEC>(base + row_off(r) + d, out);
    } else {
#pragma unroll
      for (int t = 0; t < kE; ++t) out[t] = 0.f;
    }
  }
}

template <typename T, int DH, bool VEC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int hq,
                       int rep, int sq, int skv, int bq, long long q_sb,
                       long long q_sh, long long q_ss, long long k_sb,
                       long long k_sh, long long k_ss, long long v_sb,
                       long long v_sh, long long v_ss, float scale,
                       int causal, int has_window, int window) {
  constexpr int kQStr = DH + 4;               // row stride of Q and K tiles
  constexpr int kDV = DH / 4;                 // float4 groups of a row
  constexpr int kRStep = kThreads / kDV;      // rows between a thread's rows
  constexpr int kNR = kRows / kRStep;         // output rows per thread
  static_assert(kNR >= 1 && kRows % kRStep == 0, "unsupported head dim");

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                           // [kRows][kQStr]
  float* ks = qs + kRows * kQStr;             // [kBK][kQStr]
  float* vs = ks + kBK * kQStr;               // [kBK][DH]
  float* ps = vs + kBK * DH;                  // [kRows][kPStr]
  float* m_s = ps + kRows * kPStr;            // [kRows]
  float* l_s = m_s + kRows;                   // [kRows]
  float* a_s = l_s + kRows;                   // [kRows]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int g = blockIdx.y;                   // kv head
  const int q0 = blockIdx.x * bq;             // first q position of the tile
  const int qn = min(bq, sq - q0);            // q positions in the tile
  const int nrows = qn * rep;                 // live rows, a prefix
  const int offset = skv - sq;

  // keys [k_lo, k_hi) can be attended by some row of the tile
  int k_lo = 0, k_hi = skv;
  if (causal) k_hi = min(k_hi, q0 + qn - 1 + offset + 1);
  if (has_window) k_lo = max(k_lo, q0 + offset - window + 1);

  const T* kb = k + b * k_sb + g * k_sh;
  const T* vb = v + b * v_sb + g * v_sh;
  // row r = (position r / rep, head g * rep + r % rep)
  load_tile<T, VEC, DH>(qs, kQStr, kRows, nrows, q + b * q_sb,
                        [&](int r) {
                          return (long long)(g * rep + r % rep) * q_sh +
                                 (long long)(q0 + r / rep) * q_ss;
                        });
  for (int r = tid; r < kRows; r += kThreads) {
    m_s[r] = kMasked;
    l_s[r] = 0.f;
  }

  const int rbase = tid / kDV;
  const int d4 = (tid % kDV) * 4;
  float acc[kNR][4];
#pragma unroll
  for (int i = 0; i < kNR; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int t_lo = k_lo / kBK;
  const int t_hi = k_hi > k_lo ? (k_hi + kBK - 1) / kBK : t_lo;
  for (int t = t_lo; t < t_hi; ++t) {
    const int kt0 = t * kBK;
    const int kn = min(kBK, skv - kt0);
    __syncthreads();                          // previous tile fully used
    load_tile<T, VEC, DH>(ks, kQStr, kBK, kn, kb,
                          [&](int c) { return (long long)(kt0 + c) * k_ss; });
    load_tile<T, VEC, DH>(vs, DH, kBK, kn, vb,
                          [&](int c) { return (long long)(kt0 + c) * v_ss; });
    __syncthreads();

    // scores s = (q . k) * scale, -1e30 where masked
    auto keep = [&](int r, int c) {
      const int q_pos = q0 + r / rep + offset;
      const int k_pos = kt0 + c;
      bool m = k_pos < skv;
      if (causal) m = m && k_pos <= q_pos;
      if (has_window) m = m && k_pos > q_pos - window;
      return m;
    };
    if (nrows == kRows) {
      const int tx = tid & 15, ty = tid >> 4;
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DH; d += 4) {
        float4 a[4], c4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kQStr + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          c4[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kQStr + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i].x, c4[j].x, s[i][j]);
            s[i][j] = fmaf(a[i].y, c4[j].y, s[i][j]);
            s[i][j] = fmaf(a[i].z, c4[j].z, s[i][j]);
            s[i][j] = fmaf(a[i].w, c4[j].w, s[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          ps[r * kPStr + c] = keep(r, c) ? s[i][j] * scale : kMasked;
        }
    } else {
      // few live rows (decode, the last q tile): one score per thread
      for (int idx = tid; idx < nrows * kBK; idx += kThreads) {
        const int r = idx / kBK, c = idx % kBK;
        const float* qr = qs + r * kQStr;
        const float* kr = ks + c * kQStr;
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; d += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qr + d);
          const float4 c4 = *reinterpret_cast<const float4*>(kr + d);
          s = fmaf(a.x, c4.x, s);
          s = fmaf(a.y, c4.y, s);
          s = fmaf(a.z, c4.z, s);
          s = fmaf(a.w, c4.w, s);
        }
        ps[r * kPStr + c] = keep(r, c) ? s * scale : kMasked;
      }
    }
    __syncthreads();

    // online softmax, a warp per row: p rounded to v's type for the product,
    // the running sum over the unrounded p
    const int lane = tid & 31, warp = tid >> 5;
    for (int r = warp; r < nrows; r += kThreads / 32) {
      float* pr = ps + r * kPStr;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = keep(r, lane) ? expf(s0 - m_new) : 0.f;
      const float p1 = keep(r, lane + 32) ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      pr[lane] = to_f<T>(from_f<T>(p0));
      pr[lane + 32] = to_f<T>(from_f<T>(p1));
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p' V over this thread's rows x 4 dims
#pragma unroll
    for (int i = 0; i < kNR; ++i) {
      const int r = rbase + i * kRStep;
      if (r < nrows) {
        const float* pr = ps + r * kPStr;
        float pv0 = 0.f, pv1 = 0.f, pv2 = 0.f, pv3 = 0.f;
#pragma unroll 4
        for (int c = 0; c < kBK; c += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pr + c);
          const float pc[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 x = *reinterpret_cast<const float4*>(vs + (c + u) * DH + d4);
            pv0 = fmaf(pc[u], x.x, pv0);
            pv1 = fmaf(pc[u], x.y, pv1);
            pv2 = fmaf(pc[u], x.z, pv2);
            pv3 = fmaf(pc[u], x.w, pv3);
          }
        }
        const float alpha = a_s[r];
        acc[i][0] = fmaf(acc[i][0], alpha, pv0);
        acc[i][1] = fmaf(acc[i][1], alpha, pv1);
        acc[i][2] = fmaf(acc[i][2], alpha, pv2);
        acc[i][3] = fmaf(acc[i][3], alpha, pv3);
      }
    }
  }
  __syncthreads();

  // out = acc / max(l, 1e-30), (B, Hq, Sq, DH) contiguous
#pragma unroll
  for (int i = 0; i < kNR; ++i) {
    const int r = rbase + i * kRStep;
    if (r < nrows) {
      const float l = fmaxf(l_s[r], 1e-30f);
      const int h = g * rep + r % rep;
      T* dst = o + (((long long)b * hq + h) * sq + q0 + r / rep) * DH + d4;
#pragma unroll
      for (int u = 0; u < 4; ++u) dst[u] = from_f<T>(acc[i][u] / l);
    }
  }
}

template <typename T, int DH, bool VEC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int hq, int hkv, int sq, int skv,
                   const long long* qst, const long long* kst,
                   const long long* vst, float scale, int causal,
                   int has_window, int window, cudaStream_t st) {
  const int rep = hq / hkv;
  const int bq = kRows / rep;
  const size_t smem = sizeof(float) *
      ((size_t)(kRows + kBK) * (DH + 4) + (size_t)kBK * DH +
       (size_t)kRows * kPStr + 3 * kRows);
  auto kern = flash_attention_kernel<T, DH, VEC>;
  // once per instantiation (the process drives one card), not per launch
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((sq + bq - 1) / bq, hkv, b);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, rep, sq, skv, bq,
      qst[0], qst[1], qst[2], kst[0], kst[1], kst[2], vst[0], vst[1], vst[2],
      scale, causal, has_window, window);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t dispatch_dh(int dh, const void* q, const void* k, const void* v,
                        void* o, int b, int hq, int hkv, int sq, int skv,
                        const long long* qst, const long long* kst,
                        const long long* vst, float scale, int causal,
                        int has_window, int window, cudaStream_t st) {
#define FA_CASE(D)                                                          \
  case D:                                                                   \
    return launch<T, D, VEC>(q, k, v, o, b, hq, hkv, sq, skv, qst, kst, vst, \
                             scale, causal, has_window, window, st);
  switch (dh) {
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

extern "C" {

// q (b, hq, sq, dh), k and v (b, hkv, skv, dh) of one type (is_bf16: bf16,
// else float32), each with unit stride on the last axis and element
// strides {batch, head, position} in qst / kst / vst; o (b, hq, sq, dh)
// contiguous.  hq a multiple of hkv with hq / hkv <= 64; dh one of 16, 32,
// 64, 128, 256.  vec != 0 selects 16-byte loads (pointers 16-byte aligned,
// strides multiples of 16 bytes).  window is used when has_window != 0.
// Returns the launch's CUDA error.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int b, int hq, int hkv, int sq, int skv,
                           int dh, const long long* qst, const long long* kst,
                           const long long* vst, float scale, int causal,
                           int has_window, int window, int is_bf16, int vec,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16)
    err = vec ? dispatch_dh<__nv_bfloat16, true>(
                    dh, q, k, v, o, b, hq, hkv, sq, skv, qst, kst, vst, scale,
                    causal, has_window, window, st)
              : dispatch_dh<__nv_bfloat16, false>(
                    dh, q, k, v, o, b, hq, hkv, sq, skv, qst, kst, vst, scale,
                    causal, has_window, window, st);
  else
    err = vec ? dispatch_dh<float, true>(dh, q, k, v, o, b, hq, hkv, sq, skv,
                                         qst, kst, vst, scale, causal,
                                         has_window, window, st)
              : dispatch_dh<float, false>(dh, q, k, v, o, b, hq, hkv, sq, skv,
                                          qst, kst, vst, scale, causal,
                                          has_window, window, st);
  return (int)err;
}

// Human-readable name of a CUDA error code returned by the launcher.
const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
