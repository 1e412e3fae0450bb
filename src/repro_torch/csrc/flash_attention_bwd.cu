// Backward of the fused attention (GQA, causal / sliding window aligned to
// the end of kv), for Hopper (sm_90a): route `bwd_fma` of
// kernels/flash_attention.py, two FMA kernels behind one function, for the
// calls the tensor-core route (`bwd_wgmma`, flash_attention_bwd_wgmma.cu:
// bf16 at head dim 64, 128 or 256, not compiled here) does not take — head
// dims 16 and 32, and float32 at every head dim (on the tensor cores
// float32 would be TF32).
//
// The JAX package has no backward kernel: it trains through XLA's
// `chunked_attention` (src/repro/layers/attention.py:95), and no Pallas
// kernel there has a VJP.  The port's forward is the hand-written kernel
// of csrc/flash_attention.cu, so a training step on the card needs this
// backward.  It is the derivative of the forward's function with the
// forward's rules:
//
//   offset = skv - sq; query row i sits at position i + offset; key j is
//   kept when j <= pos (causal) and j > pos - window (window given);
//   s = scale * q.k, lse = log-sum-exp of s over the kept keys, written by
//   the forward (-inf on a row with no kept key: no gradient, the forward
//   gives it 0);
//   P = exp(s - lse) on kept keys, 0 elsewhere;
//   dV = P^T dO, dP = dO V^T, D = rowsum(P o dP), dS = P o (dP - D),
//   dQ = scale * dS K, dK = scale * dS^T Q; the q heads of a GQA group sum
//   into their kv head.
// It is the derivative of the unrounded softmax: the forward rounds P to
// v's type before P V, the backward does not.  D is summed from P and dP
// in float32, not taken as rowsum(dO o O) from the forward's output as
// FlashAttention-2 does: with bf16 outputs that rounding (2^-9 of |O|)
// swamps dP - D where a row's attention is peaked on one key, and after six
// AdamW steps StarCoder2-3B's last layer was (its wq gradient's cosine to
// the plain path's fell to 0.33, H100).  So the forward's output is not an
// input.  Everything is float32 from shared memory; inputs of bf16 are
// widened on load, the results rounded once to the inputs' type.  No
// atomics: the result is deterministic.
//
// Two launches (FlashAttention-2, Dao 2023, without atomics):
// 1. flash_bwd_dq — a block per (q tile, q head, batch) walks the tile's
//    key range once with the forward's lse, recomputes P and dP and
//    accumulates, in registers, A = sum_j P dP K and B = sum_j P K, and D
//    = sum_j P dP; then dQ = scale * (A - D B), which is scale * sum_j P
//    (dP - D) K without D known in advance (in float32: the products are
//    not rounded, so nothing cancels).  It writes D to a float32 workspace
//    for launch 2.  Each K and V tile is loaded and waited on, so the
//    launch first asks L2 for the tile's whole key range (`prefetch_rows`):
//    without it each wait is a DRAM read.
// 2. flash_bwd_dkdv — a block per (key tile, kv head, batch): the K and V
//    tile stay in shared memory while it loops over the group's q heads
//    and over the q tiles whose mask reaches the tile, recomputing P and
//    dS and accumulating dK and dV in registers.  The GQA sum happens
//    inside the block.
// Tiles are 64 x 64 (32 x 32 at head dim 256, to fit shared memory); K,
// V, Q and dO tiles are held as float32 rows padded by four floats, so the
// float4 reads of 16 threads on 16 rows are conflict free.  Tiles above the
// causal diagonal or left of the window are never read.  K, V, Q and dO
// are read by strides (unit stride on the head dim): prefill's transposed
// v view is read in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention_bwd.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Rows [0, n) of a (rows, DH) tile at `src` (row stride `ld` elements) as
// float32 into `dst` (row stride DH + 4); rows past n are zero.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ld, int n, int rows) {
  for (int idx = threadIdx.x; idx < rows * DH; idx += kThreads) {
    const int r = idx / DH, c = idx - r * DH;
    dst[r * (DH + 4) + c] = r < n ? to_f(src[r * ld + c]) : 0.f;
  }
}

__device__ __forceinline__ void fma4(float& acc, const float4& a,
                                     const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& acc, float w, const float4& x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

// Score tile of a thread: rows ty + 16 r (r < TR), columns tx + 16 c
// (c < TC) of A B^T over DH, A and B float32 tiles of row stride DH + 4.
template <int DH, int TR, int TC>
__device__ __forceinline__ void dot_tile(float (&acc)[TR][TC], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int LD = DH + 4;
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float4 a[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r)
      a[r] = *reinterpret_cast<const float4*>(A + (ty + 16 * r) * LD + d);
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const float4 bb =
          *reinterpret_cast<const float4*>(B + (tx + 16 * c) * LD + d);
#pragma unroll
      for (int r = 0; r < TR; ++r) fma4(acc[r][c], a[r], bb);
    }
  }
}

__device__ __forceinline__ bool kept(int qpos, int kpos, int skv, int causal,
                                     int has_window, int window) {
  return kpos >= 0 && kpos < skv && (!causal || kpos <= qpos) &&
         (!has_window || kpos > qpos - window);
}

// Ask L2 for rows [0, n) of a (rows, DH) tile at `src` (row stride `ld`).
template <typename T, int DH>
__device__ __forceinline__ void prefetch_rows(const T* src, long long ld,
                                              int n) {
  constexpr int kRow = DH * static_cast<int>(sizeof(T));
  constexpr int kLines = kRow >= 128 ? kRow / 128 : 1;
  for (int idx = threadIdx.x; idx < n * kLines; idx += kThreads) {
    const int r = idx / kLines, l = idx - r * kLines;
    const char* p = reinterpret_cast<const char*>(src + r * ld) + 128 * l;
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
  }
}

template <int DH, int BQ, int BK>
constexpr int dq_smem_floats() {
  return (2 * BQ + 2 * BK) * (DH + 4) + 2 * BQ * (BK + 1) + 2 * BQ;
}

template <int DH, int BQ, int BK>
constexpr int dkdv_smem_floats() {
  return (2 * BQ + 2 * BK) * (DH + 4) + 2 * BQ * (BK + 1) + 2 * BQ;
}

template <typename T, int DH, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(BwdArgs a) {
  constexpr int LD = DH + 4, TR = BQ / 16, TC = BK / 16;
  constexpr int CW = DH / 4, RG = kThreads / CW, RPT = BQ / RG;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;             // the tile's P (B's weights)
  float* Ws = Ps + BQ * (BK + 1);       // and P o dP (A's and D's)
  float* lse_s = Ws + BQ * (BK + 1);
  float* del_s = lse_s + BQ;

  const int qt = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (a.hq / a.hkv);
  const int q0 = qt * BQ, nq = min(BQ, a.sq - q0), off = a.skv - a.sq;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float scale = static_cast<float>(a.scale);

  const T* qb = static_cast<const T*>(a.q) + bi * a.st_q[0] + h * a.st_q[1] +
                q0 * a.st_q[2];
  const T* dob = static_cast<const T*>(a.dout) + bi * a.st_do[0] +
                 h * a.st_do[1] + q0 * a.st_do[2];
  const T* kb = static_cast<const T*>(a.k) + bi * a.st_k[0] + kvh * a.st_k[1];
  const T* vb = static_cast<const T*>(a.v) + bi * a.st_v[0] + kvh * a.st_v[1];
  const long long row0 = (static_cast<long long>(bi) * a.hq + h) * a.sq + q0;

  load_tile<T, DH>(Qs, qb, a.st_q[2], nq, BQ);
  load_tile<T, DH>(dOs, dob, a.st_do[2], nq, BQ);

  // the keys any row of the tile keeps: [k_lo, k_hi)
  int k_lo = 0, k_hi = a.skv;
  if (a.causal) k_hi = min(a.skv, q0 + nq + off);
  if (a.has_window) k_lo = max(0, q0 + off - a.window + 1);
  // The walk below loads a K and a V tile and waits on them; ask L2 for
  // the whole range now, so those waits are L2 reads and not DRAM ones.
  const int k_first = (k_lo / BK) * BK;
  prefetch_rows<T, DH>(kb + k_first * a.st_k[2], a.st_k[2], k_hi - k_first);
  prefetch_rows<T, DH>(vb + k_first * a.st_v[2], a.st_v[2], k_hi - k_first);

  // each row's log-sum-exp, the forward's (rows past the end: +inf, P 0)
  for (int i = tid; i < BQ; i += kThreads)
    lse_s[i] = i < nq ? a.lse[row0 + i] : INFINITY;
  __syncthreads();

  // ---- A = sum_j P dP K, B = sum_j P K, D = sum_j P dP ----
  const int cq = tid % CW, rg = tid / CW;
  float4 acc_a[RPT], acc_b[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    acc_a[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    acc_b[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float dsum[TR];
#pragma unroll
  for (int r = 0; r < TR; ++r) dsum[r] = 0.f;
  for (int k0 = k_first; k0 < k_hi; k0 += BK) {
    __syncthreads();
    const int nk = min(BK, a.skv - k0);
    load_tile<T, DH>(Ks, kb + k0 * a.st_k[2], a.st_k[2], nk, BK);
    load_tile<T, DH>(Vs, vb + k0 * a.st_v[2], a.st_v[2], nk, BK);
    __syncthreads();
    float s[TR][TC] = {}, dp[TR][TC] = {};
    dot_tile<DH, TR, TC>(s, Qs, Ks, ty, tx);
    dot_tile<DH, TR, TC>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int i = ty + 16 * r, qpos = q0 + i + off;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int j = tx + 16 * c;
        float p = 0.f;
        if (i < nq && kept(qpos, k0 + j, a.skv, a.causal, a.has_window,
                           a.window))
          p = expf(s[r][c] * scale - lse_s[i]);
        const float w = p * dp[r][c];
        dsum[r] += w;
        Ps[i * (BK + 1) + j] = p;
        Ws[i * (BK + 1) + j] = w;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(Ks + j * LD + 4 * cq);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int i = rg + RG * r;
        axpy4(acc_a[r], Ws[i * (BK + 1) + j], kv);
        axpy4(acc_b[r], Ps[i * (BK + 1) + j], kv);
      }
    }
  }
  // D of each row: the 16 lanes of a row hold its columns' parts
#pragma unroll
  for (int r = 0; r < TR; ++r) {
#pragma unroll
    for (int sh = 1; sh < 16; sh <<= 1)
      dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], sh);
    if (tx == 0) {
      const int i = ty + 16 * r;
      del_s[i] = dsum[r];
      if (i < nq) a.delta[row0 + i] = dsum[r];
    }
  }
  __syncthreads();
  T* dq = static_cast<T*>(a.dq) + row0 * DH;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = rg + RG * r;
    if (i >= nq) continue;
    const float d = del_s[i];
    T* dst = dq + static_cast<long long>(i) * DH + 4 * cq;
    dst[0] = from_f<T>((acc_a[r].x - d * acc_b[r].x) * scale);
    dst[1] = from_f<T>((acc_a[r].y - d * acc_b[r].y) * scale);
    dst[2] = from_f<T>((acc_a[r].z - d * acc_b[r].z) * scale);
    dst[3] = from_f<T>((acc_a[r].w - d * acc_b[r].w) * scale);
  }
}

template <typename T, int DH, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(BwdArgs a) {
  constexpr int LD = DH + 4, TR = BQ / 16, TC = BK / 16;
  constexpr int CW = DH / 4, RG = kThreads / CW, RPT = BK / RG;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * (BK + 1);
  float* lse_s = dSs + BQ * (BK + 1);
  float* del_s = lse_s + BQ;

  const int kt = blockIdx.x, kvh = blockIdx.y, bi = blockIdx.z;
  const int rep = a.hq / a.hkv;
  const int k0 = kt * BK, nk = min(BK, a.skv - k0), off = a.skv - a.sq;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int cq = tid % CW, rg = tid / CW;
  const float scale = static_cast<float>(a.scale);

  load_tile<T, DH>(Ks,
                   static_cast<const T*>(a.k) + bi * a.st_k[0] +
                       kvh * a.st_k[1] + k0 * a.st_k[2],
                   a.st_k[2], nk, BK);
  load_tile<T, DH>(Vs,
                   static_cast<const T*>(a.v) + bi * a.st_v[0] +
                       kvh * a.st_v[1] + k0 * a.st_v[2],
                   a.st_v[2], nk, BK);

  // the q rows whose mask keeps a key of the tile: [i_lo, i_hi)
  int i_lo = 0, i_hi = a.sq;
  if (a.causal) i_lo = max(0, k0 - off);
  if (a.has_window) i_hi = min(a.sq, k0 + nk - 1 + a.window - off);

  float4 acc_k[RPT], acc_v[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    acc_k[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    acc_v[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int g = 0; g < rep; ++g) {
    const int h = kvh * rep + g;
    const T* qb = static_cast<const T*>(a.q) + bi * a.st_q[0] + h * a.st_q[1];
    const T* dob =
        static_cast<const T*>(a.dout) + bi * a.st_do[0] + h * a.st_do[1];
    const long long row_h = (static_cast<long long>(bi) * a.hq + h) * a.sq;
    for (int q0 = (i_lo / BQ) * BQ; q0 < i_hi; q0 += BQ) {
      const int nq = min(BQ, a.sq - q0);
      __syncthreads();
      load_tile<T, DH>(Qs, qb + q0 * a.st_q[2], a.st_q[2], nq, BQ);
      load_tile<T, DH>(dOs, dob + q0 * a.st_do[2], a.st_do[2], nq, BQ);
      for (int i = tid; i < BQ; i += kThreads) {
        lse_s[i] = i < nq ? a.lse[row_h + q0 + i] : INFINITY;
        del_s[i] = i < nq ? a.delta[row_h + q0 + i] : 0.f;
      }
      __syncthreads();
      float s[TR][TC] = {}, dp[TR][TC] = {};
      dot_tile<DH, TR, TC>(s, Qs, Ks, ty, tx);
      dot_tile<DH, TR, TC>(dp, dOs, Vs, ty, tx);
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const int i = ty + 16 * r, qpos = q0 + i + off;
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          const int j = tx + 16 * c;
          float p = 0.f, ds = 0.f;
          if (i < nq && kept(qpos, k0 + j, a.skv, a.causal, a.has_window,
                             a.window)) {
            p = expf(s[r][c] * scale - lse_s[i]);
            ds = p * (dp[r][c] - del_s[i]);
          }
          Ps[i * (BK + 1) + j] = p;
          dSs[i * (BK + 1) + j] = ds;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        const float4 o4 = *reinterpret_cast<const float4*>(dOs + i * LD + 4 * cq);
        const float4 q4 = *reinterpret_cast<const float4*>(Qs + i * LD + 4 * cq);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int j = rg + RG * r;
          axpy4(acc_v[r], Ps[i * (BK + 1) + j], o4);
          axpy4(acc_k[r], dSs[i * (BK + 1) + j], q4);
        }
      }
    }
  }
  const long long kv_row0 =
      (static_cast<long long>(bi) * a.hkv + kvh) * a.skv + k0;
  T* dk = static_cast<T*>(a.dk) + kv_row0 * DH;
  T* dv = static_cast<T*>(a.dv) + kv_row0 * DH;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int j = rg + RG * r;
    if (j >= nk) continue;
    T* pk = dk + static_cast<long long>(j) * DH + 4 * cq;
    T* pv = dv + static_cast<long long>(j) * DH + 4 * cq;
    pk[0] = from_f<T>(acc_k[r].x * scale);
    pk[1] = from_f<T>(acc_k[r].y * scale);
    pk[2] = from_f<T>(acc_k[r].z * scale);
    pk[3] = from_f<T>(acc_k[r].w * scale);
    pv[0] = from_f<T>(acc_v[r].x);
    pv[1] = from_f<T>(acc_v[r].y);
    pv[2] = from_f<T>(acc_v[r].z);
    pv[3] = from_f<T>(acc_v[r].w);
  }
}

template <typename T, int DH, int BQ, int BK>
cudaError_t launch(const BwdArgs& a) {
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  const int dq_bytes = dq_smem_floats<DH, BQ, BK>() * 4;
  const int kv_bytes = dkdv_smem_floats<DH, BQ, BK>() * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<T, DH, BQ, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, DH, BQ, BK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 g1((a.sq + BQ - 1) / BQ, a.hq, a.b);
  flash_bwd_dq<T, DH, BQ, BK><<<g1, kThreads, dq_bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g2((a.skv + BK - 1) / BK, a.hkv, a.b);
  flash_bwd_dkdv<T, DH, BQ, BK><<<g2, kThreads, kv_bytes, st>>>(a);
  return cudaGetLastError();
}

// Head dims 16 and 32 in both types; 64, 128 and 256 in float32 only (bf16
// there is `bwd_wgmma`'s, and is not compiled here).
template <typename T>
cudaError_t launch_dh(const BwdArgs& a) {
  switch (a.dh) {
    case 16: return launch<T, 16, 64, 64>(a);
    case 32: return launch<T, 32, 64, 64>(a);
  }
  if constexpr (std::is_same_v<T, float>) {
    if (a.dh == 64) return launch<T, 64, 64, 64>(a);
    if (a.dh == 128) return launch<T, 128, 64, 64>(a);
    if (a.dh == 256) return launch<T, 256, 32, 32>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The backward of one attention call: q and dout (b, hq, sq, dh), k and
// v (b, hkv, skv, dh), all of one type (is_bf16: bf16, else float32), unit
// stride on the head dim; dq, dk, dv contiguous of the same type;
// lse (b * hq * sq) float32, the forward's log-sum-exp (-inf on rows with
// no kept key); delta (b * hq * sq) float32 workspace; hq a multiple of
// hkv; dh 16 or 32, or in float32 also 64, 128 or 256; sq, skv >= 1.
// Two launches on `stream`; returns the first CUDA error (0 on success).
int flash_attention_backward_launch(const void* args) {
  const BwdArgs& a = *static_cast<const BwdArgs*>(args);
  if (a.b < 1 || a.hq < 1 || a.hkv < 1 || a.hq % a.hkv || a.sq < 1 ||
      a.skv < 1 || a.lse == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      a.is_bf16 ? launch_dh<__nv_bfloat16>(a) : launch_dh<float>(a);
  return static_cast<int>(err);
}

// Size of BwdArgs, for the wrapper to check its packing against.
int flash_attention_backward_args_size() { return (int)sizeof(BwdArgs); }

// Human-readable name of a CUDA error code returned by the launcher.
const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
