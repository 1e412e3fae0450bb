// Fused online-softmax attention (GQA, causal / sliding window aligned to
// the end of kv), for Hopper (sm_90a): three kernels behind one function.
//
// Replaces the TPU kernel `flash_attention` of the JAX package
// (src/repro/kernels/flash_attention.py: wrapper :108, body `_kernel` :38,
// pallas_call :154).  Every kernel computes what `_kernel` computes:
//
//   offset = skv - sq; query row i sits at absolute position i + offset;
//   a key at k_pos is kept when k_pos < skv, k_pos <= q_pos (causal) and
//   k_pos > q_pos - window (window given); masked scores are -1e30;
//   per kv tile: m_new = max(m, rowmax(s)), p = mask ? exp(s - m_new) : 0,
//   l = l * exp(m - m_new) + rowsum(p), acc = acc * exp(m - m_new) + p'V
//   where p' is p rounded to v's type; out = acc / max(l, 1e-30) in q's
//   type.  The running max, sum and accumulator are float32.  A row with
//   nothing to attend gives 0.  Given an `lse` buffer (training: the
//   backward's input), each kernel also writes the row's log-sum-exp m +
//   log(l) of the scaled scores in natural units, -inf where l = 0; a null
//   buffer (serving) writes nothing and changes nothing else.
//
// GQA without a copy in all three: a block serves one (batch, kv head) and
// all rep = Hq / Hkv q heads of its group, its rows being (q position,
// head) pairs, so each K / V tile is read once for the group.  K and V are
// taken by strides: the decode cache prefix k_cache[:, :, :pos + 1] and
// prefill's transposed (B, S, Hkv, Dh) v view are read in place.  Tiles
// above the causal diagonal or left of the window are never read.  The
// wrapper (kernels/flash_attention.py) picks the kernel by dtype and shape:
//
// 1. flash_attention_kernel_prefill_wgmma — bf16, head dim 64, 128 or 256,
//    more than one row tile.  Bound at Mistral-Nemo-12B's prefill (q
//    (8,32,512,128), kv (8,8,512,128), causal): 84 MB of q, k, v and out,
//    25 us at 3.35 TB/s, against 17 GFLOP of causal products, 17 us at 989
//    TFLOP/s, so bytes first and tensor-core issue close behind; within a
//    tile the softmax's exponentials on the special-function unit (16 a
//    clock an SM) take half as long as the products.  At head dim 256
//    (Gemma3's 2,048-token prefill, q (8,8,2048,256), kv (8,4,·)) the
//    products bound it: 137.5 GFLOP causal, 139 us, against 201 MB of
//    bytes, 60 us; a score costs twice the products of dh 128 and the same
//    exponential.  Design: persistent CTAs, one an SM, each walking (q
//    tile, batch, kv head) work items heaviest first (the last positions
//    first), so the causal tail does not form the last wave, or, where
//    the (batch, kv head) pairs alone fill the grid (MLA's 1,024), in
//    rounds that run all q tiles of a few pairs at once so their K and V
//    are read from DRAM once (`prefill_item`); a work item is 128 rows
//    (32 positions x 4 heads at a group of 4).  One thread of
//    a producer warpgroup (which hands its registers to the consumers by
//    setmaxnreg) loads the Q tile and then K and V tiles (128 keys at dh
//    64 / 128, 64 at 256: `PfPlan`) with TMA (cp.async.bulk.tensor,
//    128-byte swizzle) into rings tracked by mbarriers.  Two consumer
//    warpgroups of 64 rows each run S = Q K^T as wgmma from shared memory
//    (K stored [key][dh] is the K-major B operand), the online softmax in
//    registers (exp2 with the scale folded in, masked scores at -inf so
//    their weight is exactly 0), and O += P V as wgmma with P from
//    registers (the float32 score fragment, rounded to bf16, is already
//    the A-operand layout) and V as the MN-major B operand (transpose
//    bit); P V of tile n is issued with S of tile n + 1, so the tensor
//    cores work while the other warpgroup runs its softmax.  Tensor maps
//    are built on the host for each call from the strides (any multiple
//    of 16 bytes).  At dh 64 / 128 the output is staged through shared
//    memory and stored by TMA from a second producer thread, so the
//    consumers go straight on to the next item, whose tiles the producer
//    has already loaded; at 256 the rings fill 193 KB (one Q stage of 64
//    KB, two K and two V tiles of 32 KB) and the consumers store their
//    rows from registers.
// 2. flash_attention_kernel_decode_splitkv — any call whose rows fit one
//    64-row tile (Sq * rep <= 64: every decode step), bf16 or float32.
//    Bound at the decode step (q (8,32,1,128), an (8,8,543,128) cache
//    prefix): 17.9 MB of K and V, 5.3 us, almost no arithmetic.  Design:
//    blocks over (key split, kv head, batch) — 9 splits of 64 keys there,
//    576 blocks on 132 SMs instead of 64 — each streaming its keys in
//    32-key chunks with cp.async into 2 stages and computing in float32
//    FMA (bytes bound it), then writing a partial (m, l, acc) per row to
//    scratch.  The last block of each (batch, kv head) to finish, found by
//    an atomic ticket that it resets to 0, merges the partials in split
//    order (deterministic) in the same launch.  A split with no kept key
//    contributes m = -1e30, l = 0, which weighs 0 next to a split with
//    keys and leaves a row with nothing to attend at 0.
// 3. flash_attention_kernel — everything else: float32 prefill (tensor
//    cores would mean TF32, beyond the 2e-4 float32 limit), head dims 16
//    and 32, and a call with no keys.  The first version of this port: K and V widened to
//    float32 in shared memory, 64x64 score tiles as float32 FMA dot
//    products, a warp per row for the softmax, p'V accumulated in
//    registers; about 10 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;        // (q position, head) rows per block
constexpr int kBK = 64;          // keys per kv tile
constexpr int kPStr = kBK + 4;   // row stride of the score tile (floats)
constexpr float kMasked = -1e30f;
#define kNegInf __int_as_float(0xff800000)  // -inf

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

// A row's log-sum-exp from its running max m and sum l (natural units, the
// scale folded in); -inf for a row with no kept key (l = 0).
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : kNegInf;
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
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int hq,
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
  if (lse != nullptr) {
    for (int r = tid; r < nrows; r += kThreads)
      lse[((long long)b * hq + g * rep + r % rep) * sq + q0 + r / rep] =
          row_lse(m_s[r], l_s[r]);
  }
}

// ---------------------------------------------------------------------------
// 2. split-kv decode
// ---------------------------------------------------------------------------

constexpr int kDcChunk = 32;             // keys per cp.async stage
constexpr int kDcPStr = kDcChunk + 4;    // row stride of the score tile

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive elements of T in shared memory as floats.
template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Block (split, g, b) takes keys [split * split_keys, (split + 1) *
// split_keys) of kv head g of batch b for all sq * rep <= 64 rows; the
// partials are (m, l) at part_ml[((bg * n_split + split) * nrows + r) * 2]
// and acc at part_acc[((bg * n_split + split) * nrows + r) * DH], bg = b *
// hkv + g; counters[bg] counts the finished splits (0 between launches).
// ROWS (8 or 64) bounds sq * rep: at 8 a thread keeps one or two rows of
// the accumulator, so more blocks fit an SM.
template <typename T, int DH, bool VEC, int ROWS>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel_decode_splitkv(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int* __restrict__ counters,
    float* __restrict__ lse, int hq,
    int rep, int sq, int skv, int split_keys, int n_split, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    float scale, int causal, int has_window, int window) {
  constexpr int kQStr = DH + 4;               // Q row stride (floats)
  constexpr int kKStr = DH + 16 / sizeof(T);  // K row stride: 16 bytes of pad
  constexpr int kDV = DH / 4;                 // float4 groups of a row
  constexpr int kRStep = kThreads / kDV;      // rows between a thread's rows
  constexpr int kNR = ROWS / kRStep > 0 ? ROWS / kRStep : 1;  // rows a thread

  const int nrows = sq * rep;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                           // [nrows][kQStr]
  float* ps = qs + nrows * kQStr;             // [nrows][kDcPStr]
  float* m_s = ps + nrows * kDcPStr;          // [kRows]
  float* l_s = m_s + kRows;                   // [kRows]
  float* a_s = l_s + kRows;                   // [kRows]
  T* ks = reinterpret_cast<T*>(a_s + kRows);  // [2][kDcChunk][kKStr]
  T* vs = ks + 2 * kDcChunk * kKStr;          // [2][kDcChunk][DH]
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int bg = b * gridDim.y + g;
  const int offset = skv - sq;
  // keys [lo, hi): this split's share of those some row can attend
  int k_lo = 0, k_hi = skv;
  if (causal) k_hi = min(k_hi, sq + offset);
  if (has_window) k_lo = max(k_lo, offset - window + 1);
  const int lo = max(k_lo, split * split_keys);
  const int hi = min(k_hi, (split + 1) * split_keys);

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

  if (lo < hi) {
    const T* kb = k + b * k_sb + g * k_sh;
    const T* vb = v + b * v_sb + g * v_sh;
    // chunk c: keys lo + c * kDcChunk + [0, kDcChunk) into stage c & 1;
    // keys at or beyond hi are zero-filled (and masked)
    auto issue = [&](int c) {
      T* kd = ks + (c & 1) * kDcChunk * kKStr;
      T* vd = vs + (c & 1) * kDcChunk * DH;
      const int c0 = lo + c * kDcChunk;
      constexpr int kE = VEC ? 16 / sizeof(T) : 1;
      constexpr int kPerRow = DH / kE;
      for (int idx = tid; idx < kDcChunk * kPerRow; idx += kThreads) {
        const int r = idx / kPerRow;
        const int d = (idx % kPerRow) * kE;
        T* kdst = kd + r * kKStr + d;
        T* vdst = vd + r * DH + d;
        const int key = c0 + r;
        if (key < hi) {
          if constexpr (VEC) {
            cp_async16(kdst, kb + key * k_ss + d);
            cp_async16(vdst, vb + key * v_ss + d);
          } else {
            *kdst = kb[key * k_ss + d];
            *vdst = vb[key * v_ss + d];
          }
        } else {
#pragma unroll
          for (int t = 0; t < kE; ++t) kdst[t] = vdst[t] = from_f<T>(0.f);
        }
      }
      cp_async_commit();
    };
    auto keep = [&](int r, int key) {
      const int q_pos = r / rep + offset;
      bool m = key < hi;
      if (causal) m = m && key <= q_pos;
      if (has_window) m = m && key > q_pos - window;
      return m;
    };

    // both stages in flight before Q is read
    const int n_chunks = (hi - lo + kDcChunk - 1) / kDcChunk;
    issue(0);
    if (n_chunks > 1) issue(1);
    load_tile<T, VEC, DH>(qs, kQStr, nrows, nrows, q + b * q_sb,
                          [&](int r) {
                            return (long long)(g * rep + r % rep) * q_sh +
                                   (long long)(r / rep) * q_ss;
                          });
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();                        // chunk c (and Q) in place
      const T* kt = ks + (c & 1) * kDcChunk * kKStr;
      const T* vt = vs + (c & 1) * kDcChunk * DH;
      const int c0 = lo + c * kDcChunk;

      for (int idx = tid; idx < nrows * kDcChunk; idx += kThreads) {
        const int r = idx / kDcChunk, col = idx % kDcChunk;
        const float* qr = qs + r * kQStr;
        const T* kr = kt + col * kKStr;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;  // four short chains
#pragma unroll 8
        for (int d = 0; d < DH; d += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qr + d);
          const float4 x = load4<T>(kr + d);
          s0 = fmaf(a.x, x.x, s0);
          s1 = fmaf(a.y, x.y, s1);
          s2 = fmaf(a.z, x.z, s2);
          s3 = fmaf(a.w, x.w, s3);
        }
        const float s = (s0 + s1) + (s2 + s3);
        ps[r * kDcPStr + col] = keep(r, c0 + col) ? s * scale : kMasked;
      }
      __syncthreads();

      // online softmax, a warp per row, a lane per key
      const int lane = tid & 31, warp = tid >> 5;
      for (int r = warp; r < nrows; r += kThreads / 32) {
        float* pr = ps + r * kDcPStr;
        const float s0 = pr[lane];
        float mx = s0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        const float p0 = keep(r, c0 + lane) ? expf(s0 - m_new) : 0.f;
        float sum = p0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        pr[lane] = to_f<T>(from_f<T>(p0));
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
          const float* pr = ps + r * kDcPStr;
          float pv0 = 0.f, pv1 = 0.f, pv2 = 0.f, pv3 = 0.f;
#pragma unroll 4
          for (int col = 0; col < kDcChunk; col += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(pr + col);
            const float pc[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 x = load4<T>(vt + (col + u) * DH + d4);
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
      __syncthreads();                        // stage free for chunk c + 2
      if (c + 2 < n_chunks) issue(c + 2);
    }
  }
  __syncthreads();

  // this split's partials
  const long long slot = ((long long)bg * n_split + split) * nrows;
  for (int r = tid; r < nrows; r += kThreads) {
    part_ml[(slot + r) * 2] = m_s[r];
    part_ml[(slot + r) * 2 + 1] = l_s[r];
  }
#pragma unroll
  for (int i = 0; i < kNR; ++i) {
    const int r = rbase + i * kRStep;
    if (r < nrows)
      *reinterpret_cast<float4*>(part_acc + (slot + r) * DH + d4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counters + bg, 1) == n_split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last split to finish merges all of them in split order
  const long long first = (long long)bg * n_split * nrows;
#pragma unroll
  for (int i = 0; i < kNR; ++i) {
    const int r = rbase + i * kRStep;
    if (r >= nrows) continue;
    // the loops are unrolled so that their L2 reads are in flight together
    float mx = kMasked;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s)
      mx = fmaxf(mx, __ldcg(part_ml + (first + (long long)s * nrows + r) * 2));
    float l = 0.f, o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) {
      const long long at = first + (long long)s * nrows + r;
      const float w = expf(__ldcg(part_ml + at * 2) - mx);
      l = fmaf(__ldcg(part_ml + at * 2 + 1), w, l);
      const float4 a =
          __ldcg(reinterpret_cast<const float4*>(part_acc + at * DH + d4));
      o0 = fmaf(a.x, w, o0);
      o1 = fmaf(a.y, w, o1);
      o2 = fmaf(a.z, w, o2);
      o3 = fmaf(a.w, w, o3);
    }
    const float inv = fmaxf(l, 1e-30f);
    const int h = g * rep + r % rep;
    T* dst = o + (((long long)b * hq + h) * sq + r / rep) * DH + d4;
    dst[0] = from_f<T>(o0 / inv);
    dst[1] = from_f<T>(o1 / inv);
    dst[2] = from_f<T>(o2 / inv);
    dst[3] = from_f<T>(o3 / inv);
    if (lse != nullptr && d4 == 0)
      lse[((long long)b * hq + h) * sq + r / rep] = row_lse(mx, l);
  }
  if (tid == 0) counters[bg] = 0;
}

// ---------------------------------------------------------------------------
// 1. tensor-core prefill (bf16, head dim 64 / 128 / 256)
// ---------------------------------------------------------------------------

namespace pf {
constexpr int kThreads = 384;      // consumer warpgroups 0-1, producer 2
constexpr int kRows = 128;         // (position, head) rows of a q tile
constexpr int kWgRows = 64;        // rows of a consumer warpgroup
constexpr int kQBox = 128 * 128;   // bytes of a 128-row x 64-column bf16 box
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may have
constexpr float kLog2e = 1.4426950408889634f;
}  // namespace pf
constexpr float kLn2 = 0.6931471805599453f;

// The tiles of each head dim: PF_PLAN(head dim, keys of a K / V tile, Q
// stages, K stages, V stages).  `prefill_plan` in kernels/flash_attention.py
// gives the same numbers: its CPU test reads them from this table, and on
// the card `built_prefill_plan` reads them from `flash_prefill_plan`.  At 64
// and 128 a K / V tile holds 128 keys and two Q stages let the producer
// load the next item's Q early.  At 256 a 128-key tile (64 KB) leaves no
// room for two of each ring, and its m64n128 scores (64 registers) beside
// O's m64n256 (128) and P (32) would spill, so tiles hold 64 keys (32 KB,
// scores 32 registers, P 16) and there is one Q stage (64 KB): 193 KB.
template <int DH>
struct PfPlan;
#define PF_PLAN(DH, KEYS, QS, KS, VS)                                    \
  template <>                                                            \
  struct PfPlan<DH> {                                                    \
    static constexpr int kKeys = KEYS, kQStages = QS, kKStages = KS,     \
                         kVStages = VS;                                  \
  };
PF_PLAN(64, 128, 2, 2, 2)
PF_PLAN(128, 128, 2, 2, 2)
PF_PLAN(256, 64, 1, 2, 2)
#undef PF_PLAN

// Shared memory of the plan (1024-byte aligned): the Q ring (DH / 64 boxes
// of [128 rows][64 bf16] a tile), the K and V rings (DH / 64 boxes of
// [kKeys rows][64 bf16]), the output's staging tile where it fits (else
// each consumer stores its rows from registers), then the barriers.
template <int DH>
struct PfLayout : PfPlan<DH> {
  using P = PfPlan<DH>;
  static constexpr int kHalves = DH / 64;
  static constexpr int kKvBox = P::kKeys * 128;  // bytes of a K / V box
  static constexpr int kQTile = kHalves * pf::kQBox;
  static constexpr int kKvTile = kHalves * kKvBox;
  static constexpr int kBars = 2 * (P::kQStages + P::kKStages + P::kVStages + 1);
  static constexpr int kRings = 1024 + P::kQStages * kQTile +
                                (P::kKStages + P::kVStages) * kKvTile + 8 * kBars;
  static constexpr bool kStageOut = kRings + kQTile <= pf::kSmemMax;
  static constexpr int kSmem = kRings + (kStageOut ? kQTile : 0);
  static_assert(kSmem <= pf::kSmemMax, "the prefill plan overflows shared memory");
};

// One K or V box: the tensor map's middle dims are (key, head) unless
// `swap`, where they are (head, key) (whichever order has the smaller
// stride first; the box is one head wide, so the tile is the same).
__device__ __forceinline__ void load_kv_box(uint32_t dst, const void* map,
                                            uint32_t bar, int d0, int key,
                                            int g, int b, int swap) {
  if (swap)
    sm90::tma_load_4d(dst, map, bar, d0, g, key, b);
  else
    sm90::tma_load_4d(dst, map, bar, d0, key, g, b);
}

// 2^x by the special-function unit (relative error about 2^-22; -inf -> 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a / d for 0 <= a < 4096 and 1 <= d <= 128, given inv_d = 1.f / d: the
// float quotient of a + 1/2 lies at least 1/(2d) from an integer, far
// beyond its rounding error, so truncation gives the integer quotient.
__device__ __forceinline__ int div_small(int a, float inv_d) {
  return (int)(((float)a + 0.5f) * inv_d);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Work item w of a launch of `grid` CTAs: one q tile of one (batch, kv
// head) pair, and the kv tiles of KEYS keys its rows can attend; level 0
// is the last q tile (the heaviest under the causal mask).  Two orders:
//  per == 0 (fewer pairs than CTAs): level-major, w = level * pairs +
//    pair, so each SM starts on a heavy tile, the causal tail does not
//    form the last wave, and the CTAs on one pair's q tiles at once share
//    its K and V in L2;
//  per > 0 (the pairs alone fill the grid, as MLA's 1,024 (batch, head)
//    pairs of group 1 do): rounds of `grid` items, one a CTA.  Round r =
//    w / grid holds every q tile of pairs r * per .. r * per + per - 1
//    (per = grid / n_qt), so a pair's K and V come from DRAM once and from
//    L2 for its other q tiles; slot s takes level (s / per + r) % n_qt,
//    so over n_qt rounds every CTA takes every level once.  Slots past
//    per * n_qt and pairs past the last are no item (valid false).
struct PrefillItem {
  int b, g, q0, p_lo, p_hi, t_lo, n_t;
  bool valid;
};

template <int KEYS>
__device__ __forceinline__ PrefillItem prefill_item(
    int w, int grid, int per, int pairs, int hkv, int n_qt, int sq, int skv,
    int bq, int causal, int has_window, int window) {
  PrefillItem it;
  int bh, level;
  if (per == 0) {
    bh = w % pairs;
    level = w / pairs;
    it.valid = true;
  } else {
    const int r = w / grid, slot = w - r * grid;
    bh = r * per + slot % per;
    level = (slot / per + r) % n_qt;
    it.valid = slot < per * n_qt && bh < pairs;
  }
  it.b = bh / hkv;
  it.g = bh % hkv;
  it.q0 = (n_qt - 1 - level) * bq;
  it.p_lo = it.q0 + skv - sq;
  it.p_hi = it.p_lo + min(bq, sq - it.q0) - 1;
  int k_lo = 0, k_hi = skv;
  if (causal) k_hi = min(k_hi, it.p_hi + 1);
  if (has_window) k_lo = max(k_lo, it.p_lo - window + 1);
  it.t_lo = k_lo / KEYS;
  it.n_t = k_hi > k_lo ? (k_hi + KEYS - 1) / KEYS - it.t_lo : 0;
  return it;
}

// Persistent: gridDim.x CTAs (at most one per SM) walk the work items
// (`prefill_item`, pairs = b * hkv, n_items of them, slots that are no
// item included) w = blockIdx.x, blockIdx.x + gridDim.x, ....  Rows of a tile
// are head-major (row = head * bq + position) when q_head_major, else
// position-major (row = position * rep + head): the order of the Q tensor
// map's middle dims, chosen on the host by stride.  Shared memory as
// `PfLayout`, the tiles in the 128-byte swizzle.  A consumer issues P V of
// tile n with S of tile n + 1, so the K ring runs a tile ahead of the V
// ring and each ring frees a slot a tile before the producer needs it.
// The rings carry over from one item to the next, so the producer loads
// the next item's K and V (and, with two Q stages, its Q) while the
// consumers finish the current one; with one Q stage the next Q lands
// once both warpgroups have issued their last S of the item.
template <int DH>
__global__ void __launch_bounds__(pf::kThreads, 1)
flash_attention_kernel_prefill_wgmma(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_o, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int n_items, int per, int pairs, int hkv,
    int rep, int sq, int skv, int bq, int n_qt, float scale_log2, int causal,
    int has_window, int window, int q_head_major, int k_swap, int v_swap) {
  using namespace sm90;
  using L = PfLayout<DH>;
  constexpr int kKeys = L::kKeys;
  constexpr int kQS = L::kQStages, kKS = L::kKStages, kVS = L::kVStages;
  constexpr int kHalves = L::kHalves;
  constexpr int kNO = DH / 2;                 // output registers a thread

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_k = s_q + kQS * L::kQTile;
  const uint32_t s_v = s_k + kKS * L::kKvTile;
  const uint32_t s_o = s_v + kVS * L::kKvTile;   // the staging tile, if any
  const uint32_t s_bar = s_o + (L::kStageOut ? L::kQTile : 0);
  // full / empty barriers of the K ring, then of the V ring, then Q's
  auto k_full = [&](int n) { return s_bar + 8u * (n % kKS); };
  auto k_empty = [&](int n) { return s_bar + 8u * (kKS + n % kKS); };
  auto v_full = [&](int n) { return s_bar + 8u * (2 * kKS + n % kVS); };
  auto v_empty = [&](int n) {
    return s_bar + 8u * (2 * kKS + kVS + n % kVS);
  };
  auto q_full = [&](int j) {
    return s_bar + 8u * (2 * kKS + 2 * kVS + j % kQS);
  };
  auto q_empty = [&](int j) {
    return s_bar + 8u * (2 * kKS + 2 * kVS + kQS + j % kQS);
  };
  // the staging tile: written by the consumers, stored by the producer
  const uint32_t o_full = s_bar + 8u * (2 * (kQS + kKS + kVS));
  const uint32_t o_empty = o_full + 8u;
  // the parity of tile n's phase in a ring of `stages`
  auto phase = [](int n, int stages) { return (uint32_t)((n / stages) & 1); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  auto item = [&](int w) {
    return prefill_item<kKeys>(w, gridDim.x, per, pairs, hkv, n_qt, sq, skv,
                               bq, causal, has_window, window);
  };
  if (tid == 0) {
    for (int n = 0; n < kKS; ++n) {
      mbar_init(k_full(n), 1);
      mbar_init(k_empty(n), 2 * 128);
    }
    for (int n = 0; n < kVS; ++n) {
      mbar_init(v_full(n), 1);
      mbar_init(v_empty(n), 2 * 128);
    }
    for (int j = 0; j < kQS; ++j) {
      mbar_init(q_full(j), 1);
      mbar_init(q_empty(j), 2 * 128);
    }
    mbar_init(o_full, 2 * 128);
    mbar_init(o_empty, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer warpgroup: gives its registers to the consumers; one
    // thread keeps the rings full, another stores the staged outputs -------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (L::kStageOut && warp == 9 && lane == 0) {
      int j = 0;
#pragma unroll 1
      for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
        const PrefillItem it = item(w);
        if (!it.valid) continue;
        mbar_wait(o_full, j & 1);
        for (int h = 0; h < kHalves; ++h)
          tma_store_4d(&tm_o, s_o + h * pf::kQBox, h * 64, it.q0, it.g * rep,
                       it.b);
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(o_empty);
        ++j;
      }
      bulk_wait();                             // the last store has landed
    }
    if (warp == 8 && lane == 0) {
      int n = 0;                               // K / V tiles loaded so far
      int j = 0;                               // items of this CTA so far
#pragma unroll 1
      for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
        const PrefillItem it = item(w);
        if (!it.valid) continue;
        const uint32_t q_dst = s_q + (j % kQS) * L::kQTile;
        if (j >= kQS) mbar_wait(q_empty(j), phase(j, kQS) ^ 1);
        mbar_expect_tx(q_full(j), kHalves * 128 * rep * bq);
        for (int h = 0; h < kHalves; ++h) {
          if (q_head_major)
            tma_load_4d(q_dst + h * pf::kQBox, &tm_q, q_full(j), h * 64,
                        it.q0, it.g * rep, it.b);
          else
            tma_load_4d(q_dst + h * pf::kQBox, &tm_q, q_full(j), h * 64,
                        it.g * rep, it.q0, it.b);
        }
#pragma unroll 1
        for (int i = 0; i < it.n_t; ++i, ++n) {
          const int kt0 = (it.t_lo + i) * kKeys;
          const uint32_t k_dst = s_k + (n % kKS) * L::kKvTile;
          const uint32_t v_dst = s_v + (n % kVS) * L::kKvTile;
          if (n >= kKS) mbar_wait(k_empty(n), phase(n, kKS) ^ 1);
          mbar_expect_tx(k_full(n), L::kKvTile);
          for (int h = 0; h < kHalves; ++h)
            load_kv_box(k_dst + h * L::kKvBox, &tm_k, k_full(n), h * 64, kt0,
                        it.g, it.b, k_swap);
          if (n >= kVS) mbar_wait(v_empty(n), phase(n, kVS) ^ 1);
          mbar_expect_tx(v_full(n), L::kKvTile);
          for (int h = 0; h < kHalves; ++h)
            load_kv_box(v_dst + h * L::kKvBox, &tm_v, v_full(n), h * 64, kt0,
                        it.g, it.b, v_swap);
        }
        ++j;
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 -----------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp / 4;
    const int rl = (warp % 4) * 16 + lane / 4;  // local rows rl and rl + 8
    const float inv_bq = 1.f / bq, inv_rep = 1.f / rep;
    uint8_t* const stage = smem_raw + (s_o - raw);  // generic address

    // Each warpgroup issues P V of tile i together with S = Q K^T of tile
    // i + 1, then runs the softmax of tile i + 1 while the tensor cores
    // serve the other warpgroup; the two run free of each other, coupled
    // only through the rings.

    float sacc[kKeys / 2];           // scores of one tile (raw q . k)
    float oacc[kNO];                 // output accumulator
    uint32_t pa[kKeys / 16][4];      // P of one tile, bf16 A fragments

    // S = Q K^T of the K tile at k_tile: both operands K-major; a k16 step
    // is 32 bytes into the swizzled 128-byte rows of a box
    auto issue_s = [&](uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        const uint64_t dq = desc_sw128(q_rows + (kk / 4) * pf::kQBox + col, 16, 1024);
        const uint64_t dk =
            desc_sw128(k_tile + (kk / 4) * L::kKvBox + col, 16, 1024);
        if constexpr (kKeys == 128)
          wgmma_ss_m64n128k16(sacc, dq, dk, kk > 0);
        else
          wgmma_ss_m64n64k16(sacc, dq, dk, kk > 0);
      }
    };
    // O += P V of the V tile at v_tile: P from registers (keys 16 kk ..
    // 16 kk + 15 are fragment kk); V MN-major, 16 keys = two 8-row swizzle
    // atoms (2048 bytes), the dh boxes kKvBox apart.  At head dim 256 two
    // n128 products a k16 step: dh 0-127 into oacc[0, 64), 128-255 into
    // oacc[64, 128), the register order of one m64n256 fragment.
    auto issue_pv = [&](uint32_t v_tile) {
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint32_t at = v_tile + kk * 2048;
        const uint64_t dv = desc_sw128(at, L::kKvBox, 1024);
        if constexpr (DH == 256) {
          wgmma_rs_m64n128k16(*reinterpret_cast<float(*)[64]>(oacc), pa[kk],
                              dv);
          wgmma_rs_m64n128k16(*reinterpret_cast<float(*)[64]>(oacc + 64),
                              pa[kk],
                              desc_sw128(at + 2 * L::kKvBox, L::kKvBox, 1024));
        } else if constexpr (DH == 128) {
          wgmma_rs_m64n128k16(oacc, pa[kk], dv);
        } else {
          wgmma_rs_m64n64k16(oacc, pa[kk], dv);
        }
      }
    };

    int n = 0;                                 // K / V tiles consumed so far
    int j = 0;                                 // items of this CTA so far
#pragma unroll 1
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const PrefillItem it = item(w);
      if (!it.valid) continue;
      int q_pos[2];                            // absolute position of a row
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = wg * pf::kWgRows + rl + 8 * u;
        q_pos[u] = it.p_lo + (q_head_major ? r - div_small(r, inv_bq) * bq
                                           : div_small(r, inv_rep));
      }
#pragma unroll
      for (int i = 0; i < kNO; ++i) oacc[i] = 0.f;
      float m_run[2] = {kMasked, kMasked}, l_run[2] = {0.f, 0.f};

      // mask (-inf: weight exactly 0) and online softmax of the tile at
      // kt0, in base 2 with the scale folded in; P into pa, O rescaled.
      // Register 4 jj + e holds (row rl, key 8 jj + 2 (lane % 4) + e),
      // 4 jj + 2 + e the same key of row rl + 8.
      auto softmax = [&](int kt0) {
        const bool whole = kt0 + kKeys <= skv &&
                           (!causal || kt0 + kKeys - 1 <= it.p_lo) &&
                           (!has_window || kt0 > it.p_hi - window);
        if (!whole) {
#pragma unroll
          for (int jj = 0; jj < kKeys / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int u = e / 2;
              const int key = kt0 + 8 * jj + 2 * (lane % 4) + (e % 2);
              bool keep = key < skv;
              if (causal) keep = keep && key <= q_pos[u];
              if (has_window) keep = keep && key > q_pos[u] - window;
              if (!keep) sacc[4 * jj + e] = kNegInf;
            }
        }
        // four partial maxima and sums a row: short dependency chains,
        // as only two warps share a scheduler
        float mx4[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            mx4[u][c] = fmaxf(sacc[4 * c + 2 * u], sacc[4 * c + 2 * u + 1]);
#pragma unroll
        for (int jj = 4; jj < kKeys / 8; ++jj)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            mx4[u][jj % 4] = fmaxf(mx4[u][jj % 4],
                                   fmaxf(sacc[4 * jj + 2 * u],
                                         sacc[4 * jj + 2 * u + 1]));
        float mx[2], alpha[2], neg_m[2], sum4[2][4] = {};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          mx[u] = fmaxf(fmaxf(mx4[u][0], mx4[u][1]), fmaxf(mx4[u][2], mx4[u][3]));
          mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
          mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
          const float m_new = fmaxf(m_run[u], mx[u] * scale_log2);
          alpha[u] = fast_exp2(m_run[u] - m_new);
          m_run[u] = m_new;
          neg_m[u] = -m_new;
        }
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int u = t % 2, idx = 8 * kk + 2 * t;
            const float p0 = fast_exp2(fmaf(sacc[idx], scale_log2, neg_m[u]));
            const float p1 =
                fast_exp2(fmaf(sacc[idx + 1], scale_log2, neg_m[u]));
            sum4[u][kk % 4] += p0 + p1;
            pa[kk][t] = pack_bf16(p0, p1);
          }
        float sum[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          sum[u] = (sum4[u][0] + sum4[u][1]) + (sum4[u][2] + sum4[u][3]);
          sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], 1);
          sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], 2);
          l_run[u] = l_run[u] * alpha[u] + sum[u];
        }
        if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
          for (int jj = 0; jj < DH / 8; ++jj) {
            oacc[4 * jj] *= alpha[0];
            oacc[4 * jj + 1] *= alpha[0];
            oacc[4 * jj + 2] *= alpha[1];
            oacc[4 * jj + 3] *= alpha[1];
          }
        }
      };

      // this warpgroup's rows of the item's Q tile
      const uint32_t q_rows =
          s_q + (j % kQS) * L::kQTile + wg * (pf::kQBox / 2);
      mbar_wait(q_full(j), phase(j, kQS));
      if (it.n_t == 0) {
        mbar_arrive(q_empty(j));
      } else {
        mbar_wait(k_full(n), phase(n, kKS));
        fence_regs(sacc);
        wgmma_fence();
        issue_s(q_rows, s_k + (n % kKS) * L::kKvTile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);
        mbar_arrive(k_empty(n));
        if (it.n_t == 1) mbar_arrive(q_empty(j));  // Q read for the last time
        softmax(it.t_lo * kKeys);
      }
#pragma unroll 1
      for (int i = 0; i < it.n_t; ++i, ++n) {
        const bool more = i + 1 < it.n_t;
        if (more) mbar_wait(k_full(n + 1), phase(n + 1, kKS));
        mbar_wait(v_full(n), phase(n, kVS));
        fence_regs(oacc);
        fence_regs(sacc);
        wgmma_fence();
        issue_pv(s_v + (n % kVS) * L::kKvTile);
        if (more) issue_s(q_rows, s_k + ((n + 1) % kKS) * L::kKvTile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(oacc);
        fence_regs(sacc);
        mbar_arrive(v_empty(n));
        if (more) {
          mbar_arrive(k_empty(n + 1));
          if (i + 2 == it.n_t) mbar_arrive(q_empty(j));  // Q's last read
          softmax((it.t_lo + i + 1) * kKeys);
        }
      }

      // out = O / max(l, 1e-30) as bf16.  Staged: into the staging tile in
      // the layout of the output's tensor map box (row = head * bq +
      // position, the same swizzle), which the producer warpgroup stores
      // with one TMA store once both warpgroups have written it; positions
      // past sq fall outside the output and are not written; the tile is
      // free once the previous item's store has read it.  Else: each
      // thread stores its rows' pairs of columns to the (b, hq, sq, DH)
      // output itself.
      if (L::kStageOut && j > 0) mbar_wait(o_empty, (j - 1) & 1);
      const float inv[2] = {1.f / fmaxf(l_run[0], 1e-30f),
                            1.f / fmaxf(l_run[1], 1e-30f)};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = wg * pf::kWgRows + rl + 8 * u;   // row of the Q tile
        if (r >= bq * rep) continue;                  // past the last head
        int sr = r;                                   // row of the box
        if (!q_head_major) {
          const int pl = div_small(r, inv_rep);
          sr = (r - pl * rep) * bq + pl;
        }
        // the row's log-sum-exp in natural units (box row sr is head
        // sr / bq, position sr % bq of the item)
        const int hl = div_small(sr, inv_bq), pos = it.q0 + sr - hl * bq;
        const long long row =
            ((long long)it.b * hkv * rep + it.g * rep + hl) * sq + pos;
        if (lse != nullptr && lane % 4 == 0 && pos < sq)
          lse[row] = l_run[u] > 0.f ? (m_run[u] + log2f(l_run[u])) * kLn2
                                    : kNegInf;
        if constexpr (L::kStageOut) {
#pragma unroll
          for (int jj = 0; jj < DH / 8; ++jj) {
            const int at = (jj / 8) * pf::kQBox + sr * 128 +
                           (((jj % 8) ^ (sr % 8)) * 16) + (lane % 4) * 4;
            *reinterpret_cast<uint32_t*>(stage + at) =
                pack_bf16(oacc[4 * jj + 2 * u] * inv[u],
                          oacc[4 * jj + 2 * u + 1] * inv[u]);
          }
        } else if (pos < sq) {
          __nv_bfloat16* dst = o + row * DH + 2 * (lane % 4);
#pragma unroll
          for (int jj = 0; jj < DH / 8; ++jj)
            *reinterpret_cast<uint32_t*>(dst + 8 * jj) =
                pack_bf16(oacc[4 * jj + 2 * u] * inv[u],
                          oacc[4 * jj + 2 * u + 1] * inv[u]);
        }
      }
      if constexpr (L::kStageOut) {
        fence_async_smem();          // the stores visible to the TMA unit
        mbar_arrive(o_full);
      }
      ++j;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Element strides {batch, head, position} of q, k and v.
struct Strides {
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
};

// Raise a kernel's dynamic shared-memory limit once per instantiation (the
// process drives one card), not per launch.
template <typename Kern>
cudaError_t allow_smem(Kern kern, bool& done, size_t bytes) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

template <typename T, int DH, bool VEC>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int b, int hq, int hkv, int sq, int skv,
                       const Strides& st, float scale, int causal,
                       int has_window, int window, cudaStream_t stream) {
  const int rep = hq / hkv;
  const int bq = kRows / rep;
  const size_t smem = sizeof(float) *
      ((size_t)(kRows + kBK) * (DH + 4) + (size_t)kBK * DH +
       (size_t)kRows * kPStr + 3 * kRows);
  auto kern = flash_attention_kernel<T, DH, VEC>;
  static bool smem_set = false;
  cudaError_t err = allow_smem(kern, smem_set, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + bq - 1) / bq, hkv, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, hq, rep, sq, skv, bq,
      st.q_sb, st.q_sh, st.q_ss, st.k_sb, st.k_sh, st.k_ss, st.v_sb, st.v_sh,
      st.v_ss, scale, causal, has_window, window);
  return cudaGetLastError();
}

template <typename T, int DH>
size_t decode_smem(int nrows) {
  return sizeof(float) * ((size_t)nrows * (DH + 4 + kDcPStr) + 3 * kRows) +
         sizeof(T) * 2 * kDcChunk * ((size_t)DH + 16 / sizeof(T) + DH);
}

template <typename T, int DH, bool VEC, int ROWS>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          void* o, float* part, int* counters, float* lse,
                          int b, int hq,
                          int hkv, int sq, int skv, const Strides& st,
                          float scale, int causal, int has_window, int window,
                          int n_split, int split_keys, cudaStream_t stream) {
  const int rep = hq / hkv;
  const int nrows = sq * rep;
  auto kern = flash_attention_kernel_decode_splitkv<T, DH, VEC, ROWS>;
  static bool smem_set = false;
  cudaError_t err = allow_smem(kern, smem_set, decode_smem<T, DH>(kRows));
  if (err != cudaSuccess) return err;
  float* part_acc = part + (size_t)b * hkv * n_split * nrows * 2;
  const dim3 grid(n_split, hkv, b);
  kern<<<grid, kThreads, decode_smem<T, DH>(nrows), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), part, part_acc, counters,
      lse, hq, rep, sq, skv, split_keys, n_split, st.q_sb, st.q_sh, st.q_ss,
      st.k_sb, st.k_sh, st.k_ss, st.v_sb, st.v_sh, st.v_ss, scale, causal,
      has_window, window);
  return cudaGetLastError();
}

using sm90::EncodeTiled;
using sm90::encode_tiled;
using sm90::tensor_map;

template <int DH>
cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                           void* o, float* lse, int b, int hq, int hkv, int sq, int skv,
                           const Strides& st, float scale, int causal,
                           int has_window, int window, cudaStream_t stream) {
  using L = PfLayout<DH>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const int rep = hq / hkv;
  const int bq = pf::kRows / rep;
  // middle dims in the order of their strides (the smaller first)
  const int q_head_major = st.q_sh >= st.q_ss;
  const int k_swap = st.k_sh < st.k_ss, v_swap = st.v_sh < st.v_ss;
  CUtensorMap tq, tk, tv, to;
  const bool ok =
      (q_head_major
           ? tensor_map(enc, &tq, q, DH, sq, hq, b, st.q_ss, st.q_sh, st.q_sb,
                        bq, rep)
           : tensor_map(enc, &tq, q, DH, hq, sq, b, st.q_sh, st.q_ss, st.q_sb,
                        rep, bq)) &&
      (k_swap ? tensor_map(enc, &tk, k, DH, hkv, skv, b, st.k_sh, st.k_ss,
                           st.k_sb, 1, L::kKeys)
              : tensor_map(enc, &tk, k, DH, skv, hkv, b, st.k_ss, st.k_sh,
                           st.k_sb, L::kKeys, 1)) &&
      (v_swap ? tensor_map(enc, &tv, v, DH, hkv, skv, b, st.v_sh, st.v_ss,
                           st.v_sb, 1, L::kKeys)
              : tensor_map(enc, &tv, v, DH, skv, hkv, b, st.v_ss, st.v_sh,
                           st.v_sb, L::kKeys, 1)) &&
      // the output, (b, hq, sq, DH) contiguous, in boxes of the tile's rows
      tensor_map(enc, &to, o, DH, sq, hq, b, DH, (long long)sq * DH,
                 (long long)hq * sq * DH, bq, rep);
  if (!ok) return cudaErrorInvalidValue;
  auto kern = flash_attention_kernel_prefill_wgmma<DH>;
  static bool smem_set = false;
  cudaError_t err = allow_smem(kern, smem_set, L::kSmem);
  if (err != cudaSuccess) return err;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int pairs = b * hkv, n_qt = (sq + bq - 1) / bq;
  const int grid = min(n_sm, pairs * n_qt);
  // the order of the work items (`prefill_item`): rounds when the pairs
  // alone fill the grid
  const int per = pairs >= grid && n_qt <= grid ? grid / n_qt : 0;
  const int n_items = per ? (pairs + per - 1) / per * grid : pairs * n_qt;
  kern<<<grid, pf::kThreads, L::kSmem, stream>>>(
      tq, tk, tv, to, static_cast<__nv_bfloat16*>(o), lse, n_items, per,
      pairs, hkv, rep, sq, skv, bq, n_qt, scale * pf::kLog2e, causal,
      has_window, window, q_head_major, k_swap, v_swap);
  return cudaGetLastError();
}

#define FA_HEAD_DIMS(X) X(16) X(32) X(64) X(128) X(256)

// The arguments of a call, packed by the wrapper into one buffer (a
// single ctypes argument costs about a microsecond; thirty cost several).
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  void* part;       // split-kv scratch: float32
  void* counters;   // split-kv tickets: int32, all 0
  float* lse;       // (b, hq, sq) float32 log-sum-exp out, or null: not asked
  void* stream;
  Strides st;       // element strides {batch, head, position} of q, k, v
  int b, hq, hkv, sq, skv, dh;
  int causal, has_window, window;
  int n_split, split_keys;
  int is_bf16, vec;
  float scale;
};

template <typename T, bool VEC>
cudaError_t fma_dh(const FlashArgs& a) {
  cudaStream_t s = static_cast<cudaStream_t>(a.stream);
#define FA_CASE(D)                                                          \
  if (a.dh == D)                                                            \
    return launch_fma<T, D, VEC>(a.q, a.k, a.v, a.o, a.lse, a.b, a.hq,      \
                                 a.hkv, a.sq, a.skv, a.st, a.scale,         \
                                 a.causal, a.has_window, a.window, s);
  FA_HEAD_DIMS(FA_CASE)
#undef FA_CASE
  return cudaErrorInvalidValue;
}

template <typename T, bool VEC, int ROWS>
cudaError_t decode_dh(const FlashArgs& a) {
  cudaStream_t s = static_cast<cudaStream_t>(a.stream);
  float* part = static_cast<float*>(a.part);
  int* counters = static_cast<int*>(a.counters);
#define FA_CASE(D)                                                            \
  if (a.dh == D)                                                              \
    return launch_decode<T, D, VEC, ROWS>(                                    \
        a.q, a.k, a.v, a.o, part, counters, a.lse, a.b, a.hq, a.hkv, a.sq,    \
        a.skv, a.st, a.scale, a.causal, a.has_window, a.window, a.n_split,    \
        a.split_keys, s);
  FA_HEAD_DIMS(FA_CASE)
#undef FA_CASE
  return cudaErrorInvalidValue;
}

template <typename T, bool VEC>
cudaError_t decode_rows(const FlashArgs& a) {
  return a.sq * (a.hq / a.hkv) <= 8 ? decode_dh<T, VEC, 8>(a)
                                    : decode_dh<T, VEC, kRows>(a);
}

}  // namespace

extern "C" {

// One call of `kind`: 0 the FMA kernel (3), 1 the split-kv decode (2), 2
// the tensor-core prefill (1).  For every kind: q (b, hq, sq, dh), k and v
// (b, hkv, skv, dh) of one type (is_bf16: bf16, else float32), each with
// unit stride on the last axis; o (b, hq, sq, dh) contiguous; hq a
// multiple of hkv with hq / hkv <= 64; dh one of 16, 32, 64, 128, 256;
// window used when has_window != 0; vec != 0 when every pointer and stride
// is 16-byte aligned (16-byte loads).  Decode: sq * hq / hkv <= 64; part
// holds b * hkv * n_split * sq * hq / hkv * (dh + 2) floats; counters b *
// hkv int32, all 0 (left 0); keys split in runs of split_keys (n_split =
// ceil(skv / split_keys), at least 1).  Prefill: bf16, dh 64, 128 or 256,
// skv >= 1, vec.  Returns the launch's CUDA error (0 on success).
int flash_attention_launch(const void* args, int kind) {
  const FlashArgs& a = *static_cast<const FlashArgs*>(args);
  cudaError_t err = cudaErrorInvalidValue;
  if (kind == 0) {
    err = a.is_bf16 ? (a.vec ? fma_dh<__nv_bfloat16, true>(a)
                             : fma_dh<__nv_bfloat16, false>(a))
                    : (a.vec ? fma_dh<float, true>(a) : fma_dh<float, false>(a));
  } else if (kind == 1) {
    err = a.is_bf16 ? (a.vec ? decode_rows<__nv_bfloat16, true>(a)
                             : decode_rows<__nv_bfloat16, false>(a))
                    : (a.vec ? decode_rows<float, true>(a)
                             : decode_rows<float, false>(a));
  } else if (kind == 2 && a.is_bf16 && a.vec) {
    cudaStream_t s = static_cast<cudaStream_t>(a.stream);
#define FA_CASE(D)                                                          \
  if (a.dh == D)                                                            \
    err = launch_prefill<D>(a.q, a.k, a.v, a.o, a.lse, a.b, a.hq, a.hkv,    \
                            a.sq, a.skv, a.st, a.scale, a.causal,           \
                            a.has_window, a.window, s);
    FA_CASE(64) FA_CASE(128) FA_CASE(256)
#undef FA_CASE
  }
  return (int)err;
}

// The tensor-core prefill's plan at head dim dh as it is built: out gets
// rows of a q tile, keys of a K / V tile, the Q, K and V stages, and the
// dynamic shared memory a block asks for.  Returns 0, or
// cudaErrorInvalidValue for a head dim the prefill is not built for.
int flash_prefill_plan(int dh, int* out) {
#define FA_PLAN(D)                                                         \
  if (dh == D) {                                                           \
    using L = PfLayout<D>;                                                 \
    const int plan[6] = {pf::kRows, L::kKeys, L::kQStages, L::kKStages,    \
                         L::kVStages, L::kSmem};                           \
    for (int i = 0; i < 6; ++i) out[i] = plan[i];                          \
    return 0;                                                              \
  }
  FA_PLAN(64) FA_PLAN(128) FA_PLAN(256)
#undef FA_PLAN
  return (int)cudaErrorInvalidValue;
}

// Size of FlashArgs, for the wrapper to check its packing against.
int flash_attention_args_size() { return (int)sizeof(FlashArgs); }

// Human-readable name of a CUDA error code returned by the launcher.
const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
