// PQ ADC stage-0 scans, flat and list-major, for Hopper (sm_90a).
//
// Replaces the TPU kernels `pq_scan_topk` and `pq_ivf_scan_topk` of the JAX
// package (src/repro/kernels/pq_scan.py: :130 -> `_pq_scan_call` :97 and
// :224 -> `_pq_ivf_call` :175, both around the body `_pq_body` :51).  A
// row's score is sum_m lut[m, code[m]] over its M uint8 codes, summed in m
// order; ids of -1 (padding, tombstones, rows past the coded prefix) are
// never returned; the k best are kept per query.  The TPU body looks the
// table up as a one-hot matrix product (its VMEM has no fast gather); here
// the tables sit in shared memory and each code indexes them directly.
//
// Bound on an H100 SXM.  The flat scan reads its codes and ids once: 20 B
// a row at M = 16, 21 MB for 1M rows, 6 us at 3.35 TB/s.  What limits it
// is the lookups: Q * N * M four-byte shared-memory reads, 537M at Q = 32,
// N = 1M, M = 16, which at 132 SMs x 128 B/clk x 1.98 GHz take 0.064 ms
// even without bank conflicts; random codes make conflicts the rule.
//
// Flat scan (pq_tile_kernel<T>).  A block holds the tables of a tile of T
// queries (T = 1, 2, 4 or 8, the wrapper's choice from M * C, k and the
// 227 KB of shared memory), copied in by cp.async and transposed to the
// layout [m][code][t], so one 16-byte load brings four queries' entries of
// one code and each code byte feeds T lookups; a row's two threads (T = 8)
// read the two halves of one 32-byte entry.  The block streams a range of
// rows in tiles of 256, each tile's codes and ids copied into shared
// memory by cp.async while the previous tile is scored, so the code block
// is read Q / T times instead of Q.
// Selection per query: thresholds in registers, a warp vote before any
// append (one atomic a list and warp reserves the slots of all its takers,
// the T lists' atomics issued together), survivors appended to the
// query's list in shared memory.  When one list could overflow on the next
// tile, every list holding more than kSlack keys beyond its top-k is cut
// in the same stop, one warp each, by the radix select of scan_topk.cuh,
// which tightens each threshold to about its k-th score.  At the end each
// list is cut to its exact top-k and written as the range's part; pass 2
// (scan_topk::merge_kernel) merges each query's parts.
// Where the time goes (PERF.md): the selection, the lookups' bank
// conflicts, and the per-tile barriers, in about equal parts.

// List-major scan: the kernel body of list_scan.cuh (one launch a call, a
// cluster of CTAs a query, tombstones read from `valid`, only live rows
// scored), each CTA holding its query's table once in shared memory and
// scoring a row's codes in m order.
//
// Keys order by (score, scan position): the row index of the flat scan,
// probe rank * max_len + slot of the list-major one.

#include "list_scan.cuh"
#include "scan_topk.cuh"

namespace {

using scan_topk::Key;

// -- the flat scan: a tile of T queries a block --------------------------

constexpr int kRows = 256;            // rows of a tile (and list headroom)
constexpr int kSlack = 128;           // keys a tighten may keep beyond k
constexpr int kMaxTile = 8;
constexpr unsigned kAll = 0xffffffffu;

// Threads a row (P) and table entries a thread loads (V) at tile size T.
__host__ __device__ constexpr int row_threads(int t) { return t > 4 ? t / 4 : 1; }
__host__ __device__ constexpr int tile_threads(int t) {
  return kRows * row_threads(t);
}

__host__ __device__ inline size_t round16(size_t x) { return (x + 15) & ~size_t(15); }

// Slots of a query's survivor list: k, a tile's worth of appends before a
// tighten is due, and a tile of room after it.
__host__ __device__ inline int list_cap(int k) {
  return (k + 3 * kRows + 31) & ~31;
}

// Bytes of a tile's staging buffer: its codes (16-byte padded), its ids.
__host__ __device__ inline size_t stage_bytes(int m) {
  return round16(static_cast<size_t>(kRows) * m) + 4 * kRows;
}

// Dynamic shared memory of pq_tile_kernel<T>: the [m][code][t] tables,
// T lists, two staging buffers, counters, thresholds and T radix
// histograms.
__host__ __device__ inline size_t tile_smem_bytes(int t, int m, int c, int k) {
  return round16(sizeof(float) * static_cast<size_t>(m) * c * t) +
         sizeof(Key) * static_cast<size_t>(t) * list_cap(k) +
         2 * stage_bytes(m) + 32 + sizeof(Key) * kMaxTile +
         sizeof(int) * 256 * t;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy rows [row, row + tn) — their codes, then their ids — into a staging
// buffer; 16-byte copies when the code block is 16-byte aligned (a tile
// starts at a multiple of 256 rows), else byte loads.
template <int NT>
__device__ __forceinline__ void stage_tile(unsigned char* dst,
                                           const uint8_t* __restrict__ codes,
                                           const int* __restrict__ ids,
                                           size_t row, int tn, int m,
                                           bool aligned) {
  const uint8_t* src = codes + row * m;
  const int nb = tn * m;
  if (aligned) {
    for (int o = threadIdx.x * 16; o < nb; o += NT * 16)
      cp_async16(dst + o, src + o, min(16, nb - o));
  } else {
    for (int o = threadIdx.x; o < nb; o += NT) dst[o] = src[o];
  }
  int* id_dst = reinterpret_cast<int*>(dst + round16(static_cast<size_t>(kRows) * m));
  for (int r = threadIdx.x; r < tn; r += NT) cp_async4(id_dst + r, ids + row + r);
}

// The V table entries (queries h*V .. h*V+V-1) of code `b` at subspace j.
template <int T, int V>
__device__ __forceinline__ void entries(const float* lut_s, int j, int c,
                                        int b, int h, float (&e)[V]) {
  const float* p = lut_s + (static_cast<size_t>(j) * c + b) * T + h * V;
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    e[0] = x.x; e[1] = x.y; e[2] = x.z; e[3] = x.w;
  } else if constexpr (V == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    e[0] = x.x; e[1] = x.y;
  } else {
    e[0] = *p;
  }
}

// acc[v] = sum_m lut[q, m, code[m]] for this thread's V queries, in m
// order (the first term assigned, as the plain version sums).
template <int T, int V>
__device__ __forceinline__ void adc_tile(const float* lut_s,
                                         const unsigned char* code, int m,
                                         int c, int h, float (&acc)[V]) {
  float e[V];
  // subspace 0 assigns, the rest add (no per-term test in the loops)
  entries<T, V>(lut_s, 0, c, code[0], h, acc);
  auto add = [&](int j, int b) {
    entries<T, V>(lut_s, j, c, b, h, e);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += e[v];
  };
  if (m % 16 == 0) {
    for (int g = 0; g < m / 16; ++g) {
      const uint4 w = *reinterpret_cast<const uint4*>(code + 16 * g);
      const unsigned word[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (g + x + b > 0) add(16 * g + 4 * x + b, (word[x] >> (8 * b)) & 0xff);
    }
  } else if (m % 4 == 0) {
    for (int g = 0; g < m / 4; ++g) {
      const unsigned w = *reinterpret_cast<const unsigned*>(code + 4 * g);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (g + b > 0) add(4 * g + b, (w >> (8 * b)) & 0xff);
    }
  } else {
    for (int j = 1; j < m; ++j) add(j, code[j]);
  }
}

// grid = (query tiles, row ranges).  Thread tid scores row tid / P of each
// tile for queries (tid % P) * V .. + V - 1 of the block's tile.
template <int T>
__global__ void __launch_bounds__(tile_threads(T))
pq_tile_kernel(const float* __restrict__ lut,
               const uint8_t* __restrict__ codes, const int* __restrict__ ids,
               Key* __restrict__ part, int nq, int n, int rows_per,
               int n_parts, int m, int c, int kp) {
  constexpr int P = row_threads(T);
  constexpr int V = T / P;
  constexpr int NT = tile_threads(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int cap = list_cap(kp);
  float* lut_s = reinterpret_cast<float*>(smem);
  Key* lists = reinterpret_cast<Key*>(
      smem + round16(sizeof(float) * static_cast<size_t>(m) * c * T));
  unsigned char* stage = reinterpret_cast<unsigned char*>(lists + T * cap);
  int* cnt = reinterpret_cast<int*>(stage + 2 * stage_bytes(m));
  Key* thr_s = reinterpret_cast<Key*>(cnt + 8);
  int* hist = reinterpret_cast<int*>(thr_s + kMaxTile);

  const int q0 = blockIdx.x * T;
  const int pi = blockIdx.y;
  const int row0 = pi * rows_per;
  const int nr = min(rows_per, n - row0);
  const int n_tiles = (nr + kRows - 1) / kRows;
  const bool aligned = (reinterpret_cast<uintptr_t>(codes) & 15) == 0;

  if (n_tiles > 0)
    stage_tile<NT>(stage, codes, ids, row0, min(kRows, nr), m, aligned);
  cp_commit();
  // the tables, transposed to [m][code][t] on the way in: every entry's
  // copy in flight at once
  for (int i = threadIdx.x; i < m * c * T; i += NT) {
    const int qq = q0 + i % T;
    if (qq < nq)
      cp_async4(lut_s + i, lut + static_cast<size_t>(qq) * m * c + i / T);
    else
      lut_s[i] = 0.f;
  }
  cp_commit();
  if (threadIdx.x < T) {
    cnt[threadIdx.x] = 0;
    thr_s[threadIdx.x] = scan_topk::kEmpty;
  }
  cp_wait_all();
  __syncthreads();                       // the tables and tile 0 are in

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r_loc = threadIdx.x / P;     // row of the tile
  const int h = threadIdx.x % P;         // which V queries (= lane % P)
  Key thr[V];
  float thr_f[V];                        // a larger score cannot beat thr
  bool live[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    thr[v] = scan_topk::kEmpty;
    thr_f[v] = CUDART_INF_F;
    live[v] = q0 + h * V + v < nq;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t_row = row0 + tile * kRows;
    const int tn = min(kRows, nr - tile * kRows);
    if (tile + 1 < n_tiles)          // into the buffer tile - 1 was read from
      stage_tile<NT>(stage + ((tile + 1) & 1) * stage_bytes(m), codes, ids,
                     t_row + kRows, min(kRows, nr - (tile + 1) * kRows), m,
                     aligned);
    cp_commit();
    const unsigned char* st = stage + (tile & 1) * stage_bytes(m);
    const int* st_ids =
        reinterpret_cast<const int*>(st + round16(static_cast<size_t>(kRows) * m));
    const bool ok = r_loc < tn && st_ids[r_loc] >= 0;
    float acc[V];
    if (ok) adc_tile<T, V>(lut_s, st + r_loc * m, m, c, h, acc);
    // Votes: the warp's takers for each of this thread's lists; then
    // lanes 0..T-1 reserve the slots of list `lane` with one atomic each,
    // all at once, and every taker writes its key.
    const unsigned pos = static_cast<unsigned>(t_row + r_loc);
    const unsigned mine = P == 1 ? kAll : (h == 0 ? 0x55555555u : 0xaaaaaaaau);
    Key key[V];
    unsigned mask[V];
    unsigned any = 0;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      bool take = false;
      key[v] = scan_topk::kEmpty;
      if (ok && live[v] && acc[v] <= thr_f[v] && isfinite(acc[v])) {
        key[v] = scan_topk::make_key(acc[v], pos);
        take = key[v] < thr[v];
      }
      mask[v] = __ballot_sync(kAll, take);
      any |= mask[v];
    }
    bool full = false;            // a list this warp filled may overflow
    if (any != 0) {                                // warp-uniform
      int base = 0;
      if (lane < T) {                              // list `lane`
        const int v = lane % V;
        unsigned m = mask[0];
#pragma unroll
        for (int u = 1; u < V; ++u) m = v == u ? mask[u] : m;
        const unsigned grp = P == 1 ? kAll : ((lane / V) == 0 ? 0x55555555u : 0xaaaaaaaau);
        const int added = __popc(m & grp);
        if (added) {
          base = atomicAdd(&cnt[lane], added);
          full = base + added > cap - kRows;
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int list = h * V + v;
        const int b = __shfl_sync(kAll, base, list);
        const unsigned mv = mask[v] & mine;
        if ((mv >> lane) & 1u)
          lists[list * cap + b + __popc(mv & ((1u << lane) - 1u))] = key[v];
      }
    }
    // When one list could overflow on the next tile (its last appender
    // sees it), every list with keys to spare is cut in the same stop, one
    // warp each.  The one barrier of a tile also ends its appends and its
    // reads of the staging buffer, and makes the next tile's copies, which
    // each thread has waited for, visible.
    cp_wait_all();
    if (__syncthreads_or(full)) {
      if (warp < T && cnt[warp] > kp + kSlack) {
        Key t;
        const int kept = scan_topk::warp_tighten(lists + warp * cap, cnt[warp],
                                                 kp, kp + kSlack,
                                                 hist + warp * 256, &t);
        if (lane == 0) {
          cnt[warp] = kept;
          thr_s[warp] = t;
        }
      }
      __syncthreads();
#pragma unroll
      for (int v = 0; v < V; ++v) {
        thr[v] = thr_s[h * V + v];
        thr_f[v] = thr[v] == scan_topk::kEmpty ? CUDART_INF_F
                                               : scan_topk::key_score(thr[v]);
      }
    }
  }

  // each live list cut to its exact top-kp, written as this range's part
  if (warp < T && q0 + warp < nq) {
    Key* l = lists + warp * cap;
    int n_l = cnt[warp];
    if (n_l > kp) {
      Key t;
      n_l = scan_topk::warp_tighten(l, n_l, kp, kp, hist + warp * 256, &t);
    }
    Key* out = part + (static_cast<size_t>(q0 + warp) * n_parts + pi) * kp;
    for (int r = lane; r < kp; r += 32) out[r] = r < n_l ? l[r] : scan_topk::kEmpty;
  }
}

template <int T>
cudaError_t launch_tile(const float* lut, const uint8_t* codes, const int* ids,
                        Key* part, int nq, int n, int rows_per, int n_parts,
                        int m, int c, int kp, cudaStream_t st) {
  const size_t smem = tile_smem_bytes(T, m, c, kp);
  static int allowed[64];
  cudaError_t err = scan_topk::allow_smem(pq_tile_kernel<T>,
                                          static_cast<int>(smem), allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + T - 1) / T, n_parts);
  pq_tile_kernel<T><<<grid, tile_threads(T), smem, st>>>(
      lut, codes, ids, part, nq, n, rows_per, n_parts, m, c, kp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Flat scan.  lut (nq, m, c) float32; codes (n, m) uint8; ids (n,) int32,
// -1 = unreturnable; the rows split into n_split ranges of rows_per (a
// multiple of 256); part (nq, n_split, kp) 64-bit scratch, kp = min(k,
// rows_per); out (nq, k); tile = T, queries a block (1, 2, 4 or 8).
// Returns the first CUDA error of the two launches.
int pq_scan_topk_launch(const float* lut, const uint8_t* codes,
                        const int* ids, unsigned long long* part,
                        float* out_s, int* out_i, int nq, int n, int m, int c,
                        int n_split, int rows_per, int k, int kp, int tile,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (tile) {
    case 8: err = launch_tile<8>(lut, codes, ids, part, nq, n, rows_per, n_split, m, c, kp, st); break;
    case 4: err = launch_tile<4>(lut, codes, ids, part, nq, n, rows_per, n_split, m, c, kp, st); break;
    case 2: err = launch_tile<2>(lut, codes, ids, part, nq, n, rows_per, n_split, m, c, kp, st); break;
    case 1: err = launch_tile<1>(lut, codes, ids, part, nq, n, rows_per, n_split, m, c, kp, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(scan_topk::launch_merge(
      part, nq, n_split * kp, k, out_s, out_i, scan_topk::FlatIds{ids}, st));
}

// Shared memory of the flat scan's pass 1 at tile size `tile` (the
// wrapper's plan checks its own count against it).
int pq_tile_smem_bytes(int tile, int m, int c, int kp) {
  return static_cast<int>(tile_smem_bytes(tile, m, c, kp));
}

// List-major scan: one call described by the ListScanArgs block at `args`
// (kind 2).  Returns the launch's CUDA error.
int pq_ivf_scan_topk_launch(const void* args) {
  const ListScanArgs& a = *static_cast<const ListScanArgs*>(args);
  if (a.kind != list_scan::kPq) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(list_scan::launch<list_scan::kPq>(a));
}

// Size of ListScanArgs, for the wrapper to check its packing against.
int list_scan_args_size() { return static_cast<int>(sizeof(ListScanArgs)); }

// CTAs a query of the last launch.
int list_scan_last_cluster() { return list_scan::last_cluster(); }

// Human-readable name of a CUDA error code returned by the launchers.
const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
