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
// 8.2 GB, 2.45 ms at 3.35 TB/s; at DLRM-RM2's bulk batch (26 fields x
// 262,144 bags of one 256-byte row, 159,744 distinct rows) the 1.7 GB of
// output is nearly all of it.
//
// Design (route `vec16`: rows, strides and the table's base in 16-byte
// words, rows of at most 4 KiB).  A persistent grid, 4 CTAs an SM, each
// CTA walking tiles of consecutive positions of a walk over the (bag,
// field) output rows.  A group of G threads (G = the row's 16-byte words
// rounded up to a power of two) serves U bags of a tile; thread c of a
// group owns the 16-byte column c of each.  The walk takes the fields in
// passes (`fields_per_pass`, the wrapper's choice): all batch rows' bags
// of a pass's fields before the next pass's, so the rows a batch re-reads
// are a few fields' and stay in L2 — DLRM-RM2's 26 fields of re-read rows
// (40.9 MB) do not stay there while 1.7 GB of output streams through, even
// under the cache policy below — while the output still goes out in runs
// of whole lines (passes of all fields are memory order).  For each stage
// (a tile, or a chunk of its bags' ids when NB x L > 2,048) the CTA writes
// each bag slot's output row and field offset to shared memory once, and
// copies the ids there with cp.async a stage ahead of their use
// (double-buffered); threads read both by broadcast, so the index
// arithmetic is done once a slot, not once a thread.  Each thread then
// issues U x K independent 16-byte row loads (U bags x K ids, eight in
// flight) before the first add: U = 8, K = 1 for one-id bags, U = 1,
// K = 8 for long ones, the sums kept in registers between chunks.  Sums
// start at +0.0 and take the rows in id order, the plain version's order,
// so the two agree bit for bit (a one-id bag is 0 + row: -0.0 becomes
// +0.0, as in the plain version).  Rows are loaded with an L2 evict-last
// policy and the output stored with an evict-first one: together they
// take about a third off DLRM-RM2's bulk batch (PERF.md, measured by
// launch/embedding_bag_time.py).  A negative id is padding and is
// skipped; an id >= V reads row V - 1, as the JAX package's clamped gather
// does.  `mean` divides by max(count of valid ids, 1), counted only for
// `mean`.
//
// Route `scalar` (rows or strides that are not whole 16-byte words, an
// unaligned base, rows over 4 KiB): a group of lanes a bag, one element a
// lane, in id order — the first port's kernel.
//
// Arguments come in one block (`EmbeddingBagArgs`): one ctypes argument a
// call.  Tables are float32 or bfloat16 (template); bf16 rows are widened
// to float32 before the add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The wrapper packs this block (kernels/embedding_bag.py, ARGS), in this
// order: tab, ids, out, stream; ld_field, ld_row; n_bags, n_fields,
// bag_len, vocab, d, mean, bf16, route, fields_per_pass, group,
// bags_per_group, ids_per_step, ids_chunk, ctas.
struct EmbeddingBagArgs {
  const void* tab;        // (n_fields, vocab, d), strides ld_field, ld_row, 1
  const int* ids;         // (n_bags, bag_len) int32 contiguous; bag b of
                          // field b % n_fields (the (B, F, L) layout)
  float* out;             // (n_bags, d) float32 contiguous
  void* stream;           // cudaStream_t
  long long ld_field;     // elements between fields
  long long ld_row;       // elements between rows
  int n_bags;             // B * F
  int n_fields;
  int bag_len;            // L (may be 0)
  int vocab;
  int d;
  int mean;               // != 0: divide by max(valid ids, 1)
  int bf16;               // != 0: bfloat16 table, else float32
  int route;              // 0 vec16, 1 scalar
  int fields_per_pass;    // vec16: fields a pass of the walk (n_fields:
                          // bags in memory order)
  int group;              // threads a bag (a power of two, <= 256; scalar
                          // route: <= 32)
  int bags_per_group;     // U (vec16)
  int ids_per_step;       // K (vec16): U * K row loads before the adds
  int ids_chunk;          // ids of a bag a stage (vec16)
  int ctas;               // grid size
};

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 4;    // the tile plan's CTAs an SM (launch bounds)
constexpr int kIdsCap = 2048;    // ids a stage buffer holds
constexpr int kSlotsCap = 1024;  // bags a tile holds

// A stage's buffer: the tile's ids (a bag every ids_chunk ints) and each
// bag slot's output row and its field's byte offset in the table, computed
// once a tile.
struct Stage {
  int ids[kIdsCap];
  long long field_off[kSlotsCap];
  int bag[kSlotsCap];
};

enum { kVec16 = 0, kScalar = 1 };

// ---------------------------------------------------------------- memory --

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// One 16-byte word of a table row (read-only path, no L1 allocation).
__device__ __forceinline__ uint4 load_row16(const char* p, uint64_t pol) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, "
      "[%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ void store_out16(float* p, float a, float b,
                                            float c, float d, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;"
               :: "l"(p), "f"(a), "f"(b), "f"(c), "f"(d), "l"(pol)
               : "memory");
}

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Row of a valid id: an id >= V reads row V - 1.
__device__ __forceinline__ unsigned long long row_of(int id,
                                                     unsigned last_row) {
  return min(static_cast<unsigned>(id), last_row);
}

// A 16-byte word of T widened to float32 (exact).
template <typename T>
struct Word;

template <>
struct Word<float> {
  static constexpr int kN = 4;
  __device__ static void widen(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
  }
};

template <>
struct Word<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void widen(const uint4& r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {       // element 2i in the low half
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// kN float32 outputs of one 16-byte input word, as 16-byte stores.
template <int N>
__device__ __forceinline__ void store_word(float* o, const float* v,
                                           uint64_t pol) {
#pragma unroll
  for (int j = 0; j < N; j += 4)
    store_out16(o + j, v[j], v[j + 1], v[j + 2], v[j + 3], pol);
}

// ---------------------------------------------------------- route vec16 --

// Output row (bag) and field of walk position j.  The walk takes the
// fields in passes of fields_per_pass: a pass covers every batch row's bags
// of its fields, batch row by batch row, so a stretch of the walk reads
// those fields' tables only and writes runs of fields_per_pass output rows.
// fields_per_pass == n_fields is memory order (bag == j).
__device__ __forceinline__ void walk_at(const EmbeddingBagArgs& a, int rows,
                                        int j, int& bag, int& f) {
  const int fp = a.fields_per_pass;
  const int pass = j / (rows * fp);
  const int r = j - pass * rows * fp;
  const int w = min(fp, a.n_fields - pass * fp);   // fields in this pass
  const int b = r / w;
  f = pass * fp + (r - b * w);
  bag = b * a.n_fields + f;
}

// Fill stage s's buffer: each bag slot's output row and field offset, and
// the tile's ids of this chunk of the bags, copied asynchronously (the
// caller commits and waits, then synchronises the CTA).
__device__ __forceinline__ void stage_ids(const EmbeddingBagArgs& a,
                                          int bags_per_tile, int chunks,
                                          int rows, int elem_bytes, int s,
                                          Stage& st) {
  const int tile = blockIdx.x + (s / chunks) * gridDim.x;
  const int chunk = s % chunks;
  const int j0 = tile * bags_per_tile;
  const int nb = min(bags_per_tile, a.n_bags - j0);
  const int l0 = chunk * a.ids_chunk;
  const int lc = min(a.ids_chunk, a.bag_len - l0);
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    int f;
    walk_at(a, rows, j0 + i, st.bag[i], f);
    st.field_off[i] = f * a.ld_field * elem_bytes;
  }
  int* dst = st.ids;
  if (a.fields_per_pass == a.n_fields && lc == a.bag_len) {  // one run
    const int* src = a.ids + static_cast<long long>(j0) * a.bag_len;
    const int n = nb * lc;
    int head = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      head = n & ~3;
      for (int q = 4 * threadIdx.x; q < head; q += 4 * kThreads)
        cp_async16(dst + q, src + q);
    }
    for (int q = head + threadIdx.x; q < n; q += kThreads)
      cp_async4(dst + q, src + q);
  } else {
    for (int q = threadIdx.x; q < nb * lc; q += kThreads) {
      const int i = q / lc, l = q - i * lc;
      int bag, f;
      walk_at(a, rows, j0 + i, bag, f);
      cp_async4(dst + i * a.ids_chunk + l,
                a.ids + static_cast<long long>(bag) * a.bag_len + l0 + l);
    }
  }
}

template <typename T, int U, int K>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
embedding_bag_vec16(const __grid_constant__ EmbeddingBagArgs a) {
  constexpr int kN = Word<T>::kN;
  __shared__ __align__(16) Stage sbuf[2];
  const int group = a.group, groups = kThreads / group;
  const int g = threadIdx.x / group;
  const int c = threadIdx.x - g * group;           // 16-byte column
  const bool on = c < a.d / kN;
  const int bags_per_tile = groups * U;
  const int lchunk = a.ids_chunk;
  const int chunks = a.bag_len > lchunk ? (a.bag_len + lchunk - 1) / lchunk
                                        : 1;
  const int rows = a.n_bags / a.n_fields;          // bags a field
  const int n_tiles = (a.n_bags + bags_per_tile - 1) / bags_per_tile;
  const int my_tiles = static_cast<int>(blockIdx.x) < n_tiles
      ? (n_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;
  const int n_stages = my_tiles * chunks;
  const uint64_t pol_row = evict_last_policy();
  const uint64_t pol_out = evict_first_policy();
  const char* col = static_cast<const char*>(a.tab) + 16 * c;
  // row offsets in 32 x 32 -> 64-bit products (the route keeps the row
  // stride under 4 GiB)
  const unsigned ld_row = static_cast<unsigned>(a.ld_row * sizeof(T));
  const unsigned last_row = static_cast<unsigned>(a.vocab - 1);

  float acc[U][kN];
  int cnt[U];

  constexpr int kEs = sizeof(T);
  if (n_stages > 0)
    stage_ids(a, bags_per_tile, chunks, rows, kEs, 0, sbuf[0]);
  cp_commit();
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages)
      stage_ids(a, bags_per_tile, chunks, rows, kEs, s + 1,
                sbuf[(s + 1) & 1]);
    cp_commit();
    cp_wait_one();
    __syncthreads();
    const int tile = blockIdx.x + (s / chunks) * gridDim.x;
    const int chunk = s % chunks;
    const int j0 = tile * bags_per_tile;
    const int nb = min(bags_per_tile, a.n_bags - j0);
    const int lc = min(lchunk, a.bag_len - chunk * lchunk);
    const Stage& st = sbuf[s & 1];
    const int* ids = st.ids;
    if constexpr (K == 1) {
      // one id a bag (L == 1): U loads, then 0 + row (or 0) per bag
      uint4 x[U];
      bool v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = u * groups + g;
        const int id = i < nb ? ids[i] : -1;
        v[u] = on && id >= 0;
        if (v[u])
          x[u] = load_row16(col + st.field_off[i] + row_of(id, last_row) *
                                                           ld_row,
                            pol_row);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = u * groups + g;
        if (!on || i >= nb) continue;
        float e[kN];
        if (v[u]) {
          Word<T>::widen(x[u], e);
#pragma unroll
          for (int j = 0; j < kN; ++j) e[j] = 0.f + e[j];
        } else {
#pragma unroll
          for (int j = 0; j < kN; ++j) e[j] = 0.f;
        }
        store_word<kN>(a.out + static_cast<long long>(st.bag[i]) * a.d +
                           kN * c,
                       e, pol_out);
      }
    } else {
      if (chunk == 0) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          cnt[u] = 0;
#pragma unroll
          for (int j = 0; j < kN; ++j) acc[u][j] = 0.f;
        }
      }
      for (int l = 0; l < lc; l += K) {
        uint4 x[U][K];
        bool v[U][K];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = u * groups + g;
          const char* fb = col + (i < nb ? st.field_off[i] : 0);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int id = (i < nb && l + k < lc) ? ids[i * lchunk + l + k]
                                                  : -1;
            if (a.mean) cnt[u] += id >= 0;
            v[u][k] = on && id >= 0;
            if (v[u][k])
              x[u][k] = load_row16(fb + row_of(id, last_row) * ld_row,
                                   pol_row);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int k = 0; k < K; ++k)
            if (v[u][k]) {
              float e[kN];
              Word<T>::widen(x[u][k], e);
#pragma unroll
              for (int j = 0; j < kN; ++j) acc[u][j] += e[j];
            }
      }
      if (chunk == chunks - 1) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = u * groups + g;
          if (!on || i >= nb) continue;
          float e[kN];
          const float denom = static_cast<float>(max(cnt[u], 1));
#pragma unroll
          for (int j = 0; j < kN; ++j)
            e[j] = a.mean ? acc[u][j] / denom : acc[u][j];
          store_word<kN>(a.out + static_cast<long long>(st.bag[i]) * a.d +
                             kN * c,
                         e, pol_out);
        }
      }
    }
    __syncthreads();     // this buffer is refilled two stages on
  }
}

// --------------------------------------------------------- route scalar --

__device__ __forceinline__ float widen1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float widen1(const __nv_bfloat16* p) {
  return __bfloat162float(p[0]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
embedding_bag_scalar(const __grid_constant__ EmbeddingBagArgs a) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long bag = t / a.group;
  const int lane = static_cast<int>(t - bag * a.group);
  if (bag >= a.n_bags) return;
  const int len = a.bag_len;
  const int* bag_ids = a.ids + bag * len;
  const T* base = static_cast<const T*>(a.tab) +
                  static_cast<long long>(bag % a.n_fields) * a.ld_field;
  float* orow = a.out + bag * a.d;
  float denom = 1.f;
  if (a.mean) {
    int cnt = 0;
    for (int l = 0; l < len; ++l) cnt += __ldg(bag_ids + l) >= 0;
    denom = static_cast<float>(max(cnt, 1));
  }
  for (int c = lane; c < a.d; c += a.group) {
    const T* colp = base + c;
    float acc = 0.f;
    int l = 0;
    for (; l + 4 <= len; l += 4) {
      int id[4];
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) id[j] = __ldg(bag_ids + l + j);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (id[j] >= 0)
          x[j] = widen1(colp + static_cast<long long>(min(id[j], a.vocab - 1)) *
                                   a.ld_row);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (id[j] >= 0) acc += x[j];
    }
    for (; l < len; ++l) {
      const int id = __ldg(bag_ids + l);
      if (id >= 0)
        acc += widen1(colp + static_cast<long long>(min(id, a.vocab - 1)) *
                                 a.ld_row);
    }
    orow[c] = a.mean ? acc / denom : acc;
  }
}

// ---------------------------------------------------------------- launch --

template <typename T, int U, int K>
cudaError_t launch_vec16(const EmbeddingBagArgs& a) {
  embedding_bag_vec16<T, U, K><<<a.ctas, kThreads, 0,
                                 static_cast<cudaStream_t>(a.stream)>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const EmbeddingBagArgs& a) {
  if (a.route == kScalar) {
    embedding_bag_scalar<T><<<a.ctas, kThreads, 0,
                              static_cast<cudaStream_t>(a.stream)>>>(a);
    return cudaGetLastError();
  }
  const int words = a.d * static_cast<int>(sizeof(T)) / 16;
  if (a.group < words || a.group > kThreads || (a.group & (a.group - 1)) ||
      a.ids_chunk < 1 ||
      a.ids_chunk * (kThreads / a.group) * a.bags_per_group > kIdsCap ||
      (kThreads / a.group) * a.bags_per_group > kSlotsCap ||
      (a.ids_per_step == 1 && a.bag_len != 1))
    return cudaErrorInvalidValue;
  if (a.fields_per_pass < 1 || a.fields_per_pass > a.n_fields ||
      a.n_bags % a.n_fields)
    return cudaErrorInvalidValue;
  switch (a.bags_per_group * 16 + a.ids_per_step) {
    case 8 * 16 + 1: return launch_vec16<T, 8, 1>(a);
    case 4 * 16 + 1: return launch_vec16<T, 4, 1>(a);
    case 2 * 16 + 2: return launch_vec16<T, 2, 2>(a);
    case 1 * 16 + 4: return launch_vec16<T, 1, 4>(a);
    case 1 * 16 + 8: return launch_vec16<T, 1, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}


// --------------------------------------------------------------- backward --
//
// embedding_bag_backward: the gradient of the tables, dense (F, V, D)
// float32, zeroed by the caller.  The JAX package has no backward kernel
// (it trains through XLA's gather, src/repro/models/recsys.py:41); this is
// what jax.grad of that gather gives: each id in [0, V) of a bag adds the
// bag's d_out row to its table row (divided by the bag's count of ids >= 0
// under `mean`); negative ids are padding, and ids >= V, which the forward
// clamps to row V - 1, get nothing (the gather's transpose drops
// out-of-range indices).  One warp a (bag, field) output row, d_out read
// as 16-byte words where D is a multiple of 4, float32 atomic adds (RED)
// into the table: ids that meet in one row add in no fixed order.

__global__ void __launch_bounds__(kThreads)
embedding_bag_backward_kernel(const float* __restrict__ d_out,
                              const int* __restrict__ ids, float* d_tab,
                              long long n_bags, int n_fields, int bag_len,
                              int vocab, int d, int mean) {
  const long long w =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n_bags) return;
  const int* bag = ids + w * bag_len;
  float denom = 1.f;
  if (mean) {
    int cnt = 0;
    for (int l = lane; l < bag_len; l += 32) cnt += __ldg(bag + l) >= 0;
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
      cnt += __shfl_xor_sync(0xffffffffu, cnt, sh);
    denom = static_cast<float>(max(cnt, 1));
  }
  const float* g = d_out + w * d;
  float* tab = d_tab + static_cast<long long>(w % n_fields) * vocab * d;
  const bool vec = (d & 3) == 0;
  for (int l = 0; l < bag_len; ++l) {
    const int id = __ldg(bag + l);
    if (id < 0 || id >= vocab) continue;
    float* row = tab + static_cast<long long>(id) * d;
    if (vec) {
      for (int c = 4 * lane; c < d; c += 128) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(g + c));
        atomicAdd(row + c, mean ? x.x / denom : x.x);
        atomicAdd(row + c + 1, mean ? x.y / denom : x.y);
        atomicAdd(row + c + 2, mean ? x.z / denom : x.z);
        atomicAdd(row + c + 3, mean ? x.w / denom : x.w);
      }
    } else {
      for (int c = lane; c < d; c += 32)
        atomicAdd(row + c, mean ? __ldg(g + c) / denom : __ldg(g + c));
    }
  }
}

}  // namespace

extern "C" {

// Bytes of the argument block, for the wrapper's check of its layout.
int embedding_bag_args_size() { return sizeof(EmbeddingBagArgs); }

// Launch the kernel of `args->route` on args->stream; returns the launch's
// CUDA error (cudaErrorInvalidValue for a tile plan the kernel does not
// take).
int embedding_bag_launch(const EmbeddingBagArgs* args) {
  const EmbeddingBagArgs& a = *args;
  if (a.n_bags < 1 || a.ctas < 1 || a.n_fields < 1 || a.vocab < 1 ||
      a.group < 1 || (a.route != kVec16 && a.route != kScalar))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = a.bf16 ? launch_typed<__nv_bfloat16>(a)
                                 : launch_typed<float>(a);
  return static_cast<int>(err);
}

// The tables' gradient: d_tab (n_fields, vocab, d) float32, zeroed by the
// caller, += each valid id's share of d_out (n_bags = B * n_fields rows of
// d float32, contiguous, 16-byte aligned); ids (B, n_fields, bag_len)
// int32 contiguous.  Returns the launch's CUDA error.
int embedding_bag_backward_launch(const float* d_out, const int* ids,
                                  float* d_tab, long long n_bags,
                                  int n_fields, int bag_len, int vocab, int d,
                                  int mean, void* stream) {
  if (n_bags < 1 || n_fields < 1 || vocab < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n_bags * 32 + kThreads - 1) / kThreads;
  embedding_bag_backward_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      d_out, ids, d_tab, n_bags, n_fields, bag_len, vocab, d, mean);
  return static_cast<int>(cudaGetLastError());
}

// Human-readable name of a CUDA error code returned by the launcher.
const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
