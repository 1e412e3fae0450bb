// The list-major IVF stage-0 scans in one launch, for Hopper (sm_90a):
// float32 and int8 member slabs (ivf_scan.cu) and PQ code slabs
// (pq_scan.cu) share this kernel body and differ only in how a row slice
// is scored.
//
// Replaces the TPU kernels `ivf_scan_topk` (src/repro/kernels/ivf_scan.py
// :275, `pallas_call` :243) and `pq_ivf_scan_topk` (src/repro/kernels/
// pq_scan.py :224, `pallas_call` :193).  For each query, every live member
// of its n_probe probed lists is scored (float32 `sq - 2 q.x`, or the ADC
// sum over the row's codes in m order) and the k best are kept, ordered by
// (score, probe rank * max_len + slot): the order lax.top_k gives over the
// probed-list table.  Slots nobody fills are (+inf, -1).
//
// Bound on an H100 SXM: the bytes of the probed rows.  At the serving
// shape (Q 32, n_probe 12, max_len 512, dim 128; PERF.md §6) a query's
// probed slots are 93% live: about 92 MB of float32 rows a call when each
// query reads its own lists (23 MB int8, 3 MB of PQ codes), 28 us at
// 3.35 TB/s; 18 us when each distinct probed list is read once.
//
// Design, one launch a call.
//   * A thread-block cluster of R CTAs (R = 1, 2, 4 or 8) serves one
//     query.  The query's (probed list, 256-slot chunk) items are split
//     into R contiguous runs, one a CTA, so any n_probe from 1 to n_lists
//     spreads evenly.  The launcher picks R from the card's occupancy: the
//     fewest waves of clusters times chunks a CTA (plus a fixed cost).
//   * Thread t owns slot t of every chunk.  A chunk's rows stream into
//     shared memory in slices of up to 128 bytes, three stages deep (about
//     113 KB of shared memory at k = 64, so two CTAs share an SM): one
//     TMA load of a 256-row box a slice (16-byte aligned rows; the box
//     swizzled so that a quarter warp's 16-byte reads of its rows hit
//     distinct banks), issued by one thread and counted on an mbarrier; or,
//     for other rows, cp.async into rows padded to an odd number of 16-byte
//     units.  A thread scores its row slice after slice against the query
//     (or the ADC tables) held once per CTA in shared memory: a dot product
//     is one FMA chain in dim order, a PQ score one sum in m order, with no
//     shuffle reduction.
//   * Tombstones are read in the kernel: a slot is scored only if its id in
//     the raw member table is >= 0 and `valid[id]` is set (no masked table
//     is built per dispatch).  Each thread loads its slot's id and norm four
//     chunks ahead and its validity bit two chunks ahead, so neither the
//     row copies nor the scoring wait for them; padding rows are copied and
//     skipped.
//   * int8: the query is folded onto the codes' grid in the prologue with
//     the operations of `fold_int8_query` in its order (rintf(q / s)
//     clamped to +-127, times s, times s; IEEE division, no fast math), and
//     each code is widened exactly by a byte permute and one subtraction.
//   * Selection: a scored row's key is offered only if it beats the CTA's
//     threshold (a warp vote, one atomic a warp); the buffer takes k + 768
//     keys before a block-wide radix select (`block_select`, four
//     histograms by lane so that a hot digit costs fewer same-address
//     atomics, four keys a thread a compaction round) cuts it to at most
//     k + 64 and tightens the threshold to about the k-th key.  At the end
//     each CTA keeps at most k + 64 keys (its exact k when it serves the
//     query alone); rank 0 reads the other CTAs' keys over distributed
//     shared memory (eight a thread in flight at once), offers them the
//     same way, cuts to the exact k and writes them in order (a rank count
//     up to 64 keys, a bitonic sort above).
// Arguments come in one block (`ListScanArgs`): one ctypes argument a call.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <mutex>

#include "scan_topk.cuh"
#include "sm90.cuh"

namespace {   // internal linkage: each library that includes this has its own
namespace list_scan {

namespace cg = cooperative_groups;
using scan_topk::Key;
using scan_topk::kEmpty;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 256;            // slots of a chunk: one a thread
constexpr int kSlice = 128;           // most bytes of a row slice (a stage)
constexpr int kStages = 3;            // slices in flight: kStages - 1
constexpr int kRoom = 512;            // keys the buffer holds beyond k
constexpr int kCutSlack = 64;         // keys a cut may keep beyond k
constexpr int kHists = 4;             // radix histograms, by lane % 4
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr unsigned kAll = 0xffffffffu;

enum Kind { kF32 = 0, kInt8 = 1, kPq = 2 };

}  // namespace list_scan
}  // namespace

// The arguments of a call, packed by the wrappers (kernels/ivf_scan.py,
// kernels/pq_scan.py) into one block.
struct ListScanArgs {
  const float* q;              // (nq, ld_q) float32 queries (kinds 0, 1)
  const float* lut;            // (nq, width, c) ADC tables (kind 2), query
                               // stride ld_q, subspace stride ld_m
  const float* scale;          // (width,) int8 grid (kind 1)
  const int* probe;            // (nq, n_probe) distinct list indices
  const void* rows;            // (n_lists * max_len, width) slabs
  const float* sq;             // (n_lists * max_len,) norms (kinds 0, 1)
  const int* lists;            // (n_lists, ld_lists) ids, -1 = no member
  const unsigned char* valid;  // (n_valid,) bool, or null: every id live
  float* out_s;                // (nq, k)
  int* out_i;                  // (nq, k)
  void* stream;
  int kind;                    // list_scan::Kind
  int nq, ld_q, n_probe, n_lists, max_len, ld_lists;
  int width;                   // dims of a row (kinds 0, 1) or codes (M)
  int c;                       // entries of an ADC table row (kind 2)
  int k;
  int cluster;                 // CTAs a query; 0: the launcher chooses
  int n_valid;
  int ld_m;                    // lut: floats between subspace rows
};

namespace {
namespace list_scan {

// How a launch stages row slices.
struct Stage {
  int tma;     // 1: TMA boxes of 256 rows x slice bytes; 0: cp.async
  int slice;   // bytes of a full slice (cp.async: the last may be shorter)
  int pitch;   // bytes between two rows of a stage in shared memory
  int swz;     // the swizzle's mask of 16-byte units (7, 3, 1; 0: none)
  int gran;    // cp.async: bytes a copy moves (4; 1: plain loads)
};

// The kernel's parameter: the slabs' tensor map (TMA), the call's
// arguments and the staging plan.
struct ScanParams {
  CUtensorMap map;
  ListScanArgs a;
  Stage st;
};

__host__ __device__ inline int row_bytes(const ListScanArgs& a) {
  return a.kind == kF32 ? 4 * a.width : a.width;
}
__host__ __device__ inline size_t round_up(size_t x, size_t m) {
  return (x + m - 1) / m * m;
}
__host__ __device__ inline int buf_cap(int k) {
  return k + kRoom + 2 * kRows;
}

inline Stage plan_stage(const ListScanArgs& a) {
  const int rb = row_bytes(a);
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.rows);
  Stage s;
  if (rb % 16 == 0 && base % 16 == 0) {
    s.tma = 1;
    s.slice = rb % 128 == 0 ? 128 : rb % 64 == 0 ? 64 : rb % 32 == 0 ? 32 : 16;
    s.pitch = s.slice;
    s.swz = s.slice / 16 - 1;
    s.gran = 16;
  } else {
    s.tma = 0;
    s.slice = rb < kSlice ? rb : kSlice;
    int units = (s.slice + 15) / 16;
    if (units % 2 == 0) ++units;
    s.pitch = 16 * units;
    s.swz = 0;
    s.gran = (rb % 4 == 0 && base % 4 == 0) ? 4 : 1;
  }
  return s;
}

// Dynamic shared memory: stages (1024-byte aligned for the swizzle), the
// table (query or ADC tables), the key buffer, the stages' mbarriers, and
// room to align the base.
struct Layout {
  size_t stage, table, buf, bars, total;
  __host__ __device__ Layout(const ListScanArgs& a, const Stage& s) {
    stage = 0;
    table = stage + static_cast<size_t>(kStages) * kRows * s.pitch;
    const size_t tab = a.kind == kPq
                           ? sizeof(float) * static_cast<size_t>(a.width) * a.c
                           : sizeof(float) * static_cast<size_t>(a.width);
    buf = round_up(table + tab, 16);
    bars = buf + sizeof(Key) * static_cast<size_t>(buf_cap(a.k));
    total = bars + 8 * kStages + 1024;
  }
};

struct SelShared {
  Key thr;
  int cnt;
  int wcnt[kWarps];
  unsigned red[4];
  int res[3];
  int hist[kHists][256];       // lane % kHists: fewer same-bin atomics
};

// Block-wide radix select over buf[0, n) (n > k, distinct keys): keeps the
// keys at or below a pivot P with at least k keys at or below it and at
// most `limit` (limit >= k), and returns how many it kept; sh.thr becomes
// the bound a later key must stay below and sh.cnt the count.  Digits of 8
// bits from the first byte in which two keys differ; it stops once the
// keys at or below the pivot's bucket fit `limit` (limit == k runs to the
// exact k-th key).  Every thread calls it.
__device__ int block_select(Key* buf, int n, int k, int limit, SelShared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Key k_or = 0, k_and = ~0ull;
  for (int i = tid; i < n; i += kThreads) {
    const Key x = buf[i];
    k_or |= x;
    k_and &= x;
  }
  const unsigned v0 = __reduce_or_sync(kAll, static_cast<unsigned>(k_or >> 32));
  const unsigned v1 = __reduce_or_sync(kAll, static_cast<unsigned>(k_or));
  const unsigned v2 = __reduce_and_sync(kAll, static_cast<unsigned>(k_and >> 32));
  const unsigned v3 = __reduce_and_sync(kAll, static_cast<unsigned>(k_and));
  if (tid == 0) {
    sh.red[0] = 0u;
    sh.red[1] = 0u;
    sh.red[2] = ~0u;
    sh.red[3] = ~0u;
  }
  __syncthreads();
  if (lane == 0) {
    atomicOr(&sh.red[0], v0);
    atomicOr(&sh.red[1], v1);
    atomicAnd(&sh.red[2], v2);
    atomicAnd(&sh.red[3], v3);
  }
  __syncthreads();
  const Key kor = (static_cast<Key>(sh.red[0]) << 32) | sh.red[1];
  const Key kand = (static_cast<Key>(sh.red[2]) << 32) | sh.red[3];
  const Key diff = kor ^ kand;
  const int start =
      diff ? ((63 - __clzll(static_cast<long long>(diff))) / 8) * 8 : 0;
  Key hi_mask = start == 56 ? 0ull : ~((1ull << (start + 8)) - 1);
  Key prefix = kand & hi_mask;
  Key top = ~0ull;
  int below = 0, need = k;
  int* my_hist = sh.hist[lane % kHists];
  for (int shift = start; shift >= 0; shift -= 8) {
#pragma unroll
    for (int c = 0; c < kHists; ++c) sh.hist[c][tid] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      const Key x = buf[i];
      if ((x & hi_mask) == prefix)
        atomicAdd(&my_hist[static_cast<int>((x >> shift) & 255)], 1);
    }
    __syncthreads();
    if (warp == 0) {
      int h[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        h[j] = 0;
#pragma unroll
        for (int c = 0; c < kHists; ++c) h[j] += sh.hist[c][lane * 8 + j];
        sum += h[j];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kAll, incl, off);
        if (lane >= off) incl += t;
      }
      const int excl = incl - sum;
      if (excl < need && need <= incl) {      // exactly one lane
        int run = excl;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (run + h[j] >= need) {
            sh.res[0] = lane * 8 + j;
            sh.res[1] = run;
            sh.res[2] = h[j];
            break;
          }
          run += h[j];
        }
      }
    }
    __syncthreads();
    const int digit = sh.res[0], before = sh.res[1], in_bucket = sh.res[2];
    below += before;
    need -= before;
    prefix |= static_cast<Key>(digit) << shift;
    hi_mask |= static_cast<Key>(255) << shift;
    top = prefix | (shift ? (1ull << shift) - 1 : 0ull);
    if (below + in_bucket <= limit) break;
  }
  // keep the keys <= top, in order: rounds of four keys a thread (a
  // thread's output never passes its input, so one buffer serves)
  int kept = 0;
  for (int base = 0; base < n; base += 4 * kThreads) {
    Key x[4];
    int mine = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + 4 * tid + u;
      x[u] = i < n ? buf[i] : ~0ull;
      mine += i < n && x[u] <= top;
    }
    int incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kAll, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) sh.wcnt[warp] = incl;
    __syncthreads();
    int off = kept + incl - mine, tot = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = sh.wcnt[w];
      off += w < warp ? c : 0;
      tot += c;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (base + 4 * tid + u < n && x[u] <= top) buf[off++] = x[u];
    kept += tot;
    __syncthreads();
  }
  if (tid == 0) {
    sh.cnt = kept;
    sh.thr = top == ~0ull ? top : top + 1;
  }
  __syncthreads();
  return kept;
}

// Offer one key a thread (kEmpty offers nothing): a warp vote, one atomic
// a warp.  Returns true in the lane whose append left the buffer within
// one round of keys of its capacity (the caller cuts it before the next).
__device__ __forceinline__ bool offer(Key key, Key* buf, int cap,
                                      SelShared& sh, Key thr) {
  const int lane = threadIdx.x & 31;
  const bool take = key < thr;
  const unsigned m = __ballot_sync(kAll, take);
  if (m == 0u) return false;
  int base = 0;
  bool full = false;
  if (lane == 0) {
    base = atomicAdd(&sh.cnt, __popc(m));
    full = base + __popc(m) > cap - kRows;
  }
  base = __shfl_sync(kAll, base, 0);
  if (take) buf[base + __popc(m & ((1u << lane) - 1u))] = key;
  return full;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// int8 code byte b of a word, widened exactly: the byte + 128 placed in
// the mantissa of 2^23, minus 2^23 + 128.
__device__ __forceinline__ float i8f(unsigned biased, int b) {
  return __uint_as_float(__byte_perm(biased, 0x4B00u, 0x5440u | b)) -
         8388736.0f;
}

// Accumulate one row slice of `sb` bytes onto acc.  A slice of whole
// 16-byte units holds unit u at row + 16 (u ^ sw) (`sw`: the swizzle's
// XOR for this row); kind 0 sums q.x and kind 1 q.code in element order by
// FMA (`tab`: the query from the slice's first element), kind 2 the ADC
// lookups in m order (`tab`: the tables from the slice's first subspace,
// rows of c entries).
template <int KIND>
__device__ __forceinline__ float score_slice(const unsigned char* row, int sw,
                                             int sb, const float* tab, int c,
                                             float acc) {
  if ((sb & 15) == 0) {
    for (int u = 0; u < (sb >> 4); ++u) {
      const uint4 w = *reinterpret_cast<const uint4*>(row + 16 * (u ^ sw));
      if constexpr (KIND == kF32) {
        const float4 y = reinterpret_cast<const float4*>(tab)[u];
        acc = fmaf(__uint_as_float(w.x), y.x, acc);
        acc = fmaf(__uint_as_float(w.y), y.y, acc);
        acc = fmaf(__uint_as_float(w.z), y.z, acc);
        acc = fmaf(__uint_as_float(w.w), y.w, acc);
      } else if constexpr (KIND == kInt8) {
        const unsigned word[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                                  w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float4 y = reinterpret_cast<const float4*>(tab)[4 * u + h];
          acc = fmaf(i8f(word[h], 0), y.x, acc);
          acc = fmaf(i8f(word[h], 1), y.y, acc);
          acc = fmaf(i8f(word[h], 2), y.z, acc);
          acc = fmaf(i8f(word[h], 3), y.w, acc);
        }
      } else {
        const unsigned word[4] = {w.x, w.y, w.z, w.w};
        const float* t = tab + static_cast<size_t>(16 * u) * c;
#pragma unroll
        for (int h = 0; h < 4; ++h)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc += t[(4 * h + b) * c + ((word[h] >> (8 * b)) & 0xff)];
      }
    }
  } else {                                   // unswizzled, any length
    if constexpr (KIND == kF32) {
      const float* x = reinterpret_cast<const float*>(row);
      for (int i = 0; i < (sb >> 2); ++i) acc = fmaf(x[i], tab[i], acc);
    } else if constexpr (KIND == kInt8) {
      const signed char* x = reinterpret_cast<const signed char*>(row);
      for (int i = 0; i < sb; ++i)
        acc = fmaf(static_cast<float>(x[i]), tab[i], acc);
    } else {
      for (int i = 0; i < sb; ++i) acc += tab[i * c + row[i]];
    }
  }
  return acc;
}

// grid = nq * R CTAs in clusters of R; cluster qi serves query qi.
template <int KIND>
__global__ void __launch_bounds__(kThreads, 2)   // two CTAs an SM
list_scan_kernel(const __grid_constant__ ScanParams P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ SelShared sh;
  const ListScanArgs& a = P.a;
  const Stage& sg = P.st;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int qi = blockIdx.x / cs;
  const int tid = threadIdx.x;

  const uint32_t raw = sm90::smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const Layout L(a, sg);
  unsigned char* stage = smem + L.stage;
  float* tab = reinterpret_cast<float*>(smem + L.table);
  Key* buf = reinterpret_cast<Key*>(smem + L.buf);
  const uint32_t bars = sm90::smem_u32(smem + L.bars);
  const int k = a.k;
  const int cap = buf_cap(k);

  // this CTA's run of the query's (probed list, chunk) items
  const int ch_per_list = (a.max_len + kRows - 1) / kRows;
  const int n_ch = a.n_probe * ch_per_list;
  const int c0 = static_cast<int>(static_cast<long long>(n_ch) * rank / cs);
  const int c1 = static_cast<int>(static_cast<long long>(n_ch) * (rank + 1) / cs);
  const int n_my = c1 - c0;
  const int rb = row_bytes(a);
  const int ns = (rb + sg.slice - 1) / sg.slice;
  const int n_steps = n_my * ns;
  const int* probe_q = a.probe + static_cast<size_t>(qi) * a.n_probe;
  const unsigned char* rows = static_cast<const unsigned char*>(a.rows);
  const int stage_bytes = kRows * sg.pitch;

  // Start slice `step`'s copy into stage step % kStages: the chunk's 256
  // rows of its list's slab (TMA: rows past the slabs read as 0; cp.async:
  // rows past max_len are not copied); slots past max_len are dead.
  auto issue = [&](int step) {
    const int c = step / ns, j = step - c * ns;
    const int gc = c0 + c;
    const int in_list = (gc % ch_per_list) * kRows;
    const int row0 = __ldg(probe_q + gc / ch_per_list) * a.max_len + in_list;
    const int off_b = j * sg.slice;
    const int b = step % kStages;
    unsigned char* dst = stage + b * stage_bytes;
    if (sg.tma) {
      if (tid == 0) {
        sm90::fence_async_smem();
        sm90::mbar_expect_tx(bars + 8 * b, kRows * sg.slice);
        sm90::tma_load_2d(sm90::smem_u32(dst), &P.map, bars + 8 * b, off_b,
                          row0);
      }
      return;
    }
    const int sb = min(sg.slice, rb - off_b);
    const int nr = min(kRows, a.max_len - in_list);
    const unsigned char* src = rows + static_cast<size_t>(row0) * rb + off_b;
    if (sg.gran == 4) {
      const int per = sb >> 2;
      for (int e = tid; e < nr * per; e += kThreads) {
        const int r = e / per, p = e - r * per;
        cp_async4(dst + r * sg.pitch + 4 * p,
                  src + static_cast<size_t>(r) * rb + 4 * p);
      }
    } else {
      for (int e = tid; e < nr * sb; e += kThreads) {
        const int r = e / sb, p = e - r * sb;
        dst[r * sg.pitch + p] = src[static_cast<size_t>(r) * rb + p];
      }
    }
  };

  if (tid == 0) {
    sh.cnt = 0;
    sh.thr = kEmpty;
    if (sg.tma) {
      for (int b = 0; b < kStages; ++b) sm90::mbar_init(bars + 8 * b, 1);
      sm90::mbar_fence_init();
    }
  }
  if (sg.tma) {                          // the first slices' loads, at once
    for (int s = 0; s < kStages - 1 && s < n_steps; ++s) issue(s);
  }
  // the scoring table's copies first (cp.async group 0): the ADC tables,
  // or the float32 query; the int8 query is folded below
  if constexpr (KIND == kPq) {
    const float* src = a.lut + static_cast<size_t>(qi) * a.ld_q;
    const int n = a.width * a.c;
    if (a.c % 4 == 0 && a.ld_m % 4 == 0 &&
        reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      for (int i = 4 * tid; i < n; i += 4 * kThreads) {
        const int m = i / a.c;
        cp_async16(tab + i, src + static_cast<size_t>(m) * a.ld_m + (i - m * a.c));
      }
    } else {
      for (int i = tid; i < n; i += kThreads) {
        const int m = i / a.c;
        cp_async4(tab + i, src + static_cast<size_t>(m) * a.ld_m + (i - m * a.c));
      }
    }
  } else if constexpr (KIND == kF32) {
    const float* src = a.q + static_cast<size_t>(qi) * a.ld_q;
    for (int d = tid; d < a.width; d += kThreads) cp_async4(tab + d, src + d);
  }
  cp_commit();
  __syncthreads();                       // the barriers are initialised

  if (!sg.tma) {
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_steps) issue(s);
      cp_commit();
    }
  }

  if constexpr (KIND == kInt8) {
    const float* src = a.q + static_cast<size_t>(qi) * a.ld_q;
    for (int d = tid; d < a.width; d += kThreads) {
      const float s = a.scale[d];
      float v = fminf(fmaxf(rintf(src[d] / s), -127.f), 127.f);
      tab[d] = v * s * s;
    }
  }

  // Slot `tid` of chunk c (this CTA's numbering): its id and norm, loaded
  // four chunks ahead; its validity bit two chunks ahead.
  auto load_ids = [&](int c, int& id, float& sqv) {
    id = -1;
    sqv = 0.f;
    if (c >= n_my) return;
    const int gc = c0 + c;
    const int slot = (gc % ch_per_list) * kRows + tid;
    if (slot >= a.max_len || slot >= a.ld_lists) return;
    const int lst = __ldg(probe_q + gc / ch_per_list);
    id = __ldg(a.lists + static_cast<size_t>(lst) * a.ld_lists + slot);
    if constexpr (KIND != kPq)
      sqv = __ldg(a.sq + static_cast<size_t>(lst) * a.max_len + slot);
  };
  auto load_valid = [&](int id) -> bool {
    if (id < 0) return false;
    if (a.valid == nullptr) return true;
    return id < a.n_valid && __ldg(a.valid + id) != 0;
  };
  // chunk c + i's id (i = 2, 3), norm (i = 0..3) and validity (i = 0, 1)
  // at the start of chunk c
  int id0, id1, id2, id3;
  float s0, s1, s2, s3;
  load_ids(0, id0, s0);
  load_ids(1, id1, s1);
  load_ids(2, id2, s2);
  load_ids(3, id3, s3);
  bool v0 = load_valid(id0), v1 = load_valid(id1);
  if (sg.tma) cp_wait<0>();              // the table (TMA steps: mbarriers)

  Key thr = kEmpty;
  bool full = false, live = false;
  float acc = -0.f;           // -0 + x == x: the first term is exact
  float my_sq = 0.f;
  int c = 0, j = 0;           // the step being scored: chunk, slice
  for (int s = 0; s < n_steps; ++s) {
    if (j == 0) {             // this chunk's slot; the next chunks' loads
      live = v0;
      my_sq = s0;
      v0 = v1;
      s0 = s1;
      v1 = load_valid(id2);
      s1 = s2;
      id2 = id3;
      s2 = s3;
      load_ids(c + 4, id3, s3);
      acc = -0.f;
    }
    const int b = s % kStages;
    if (sg.tma)
      sm90::mbar_wait(bars + 8 * b, (s / kStages) & 1);
    else
      cp_wait<kStages - 2>();
    if (__syncthreads_or(full)) {
      block_select(buf, sh.cnt, k, k + kCutSlack, sh);
      full = false;
    }
    thr = sh.thr;
    const int off_b = j * sg.slice;
    if (live) {
      const int at = tid * sg.pitch;
      const float* t = KIND == kPq ? tab + static_cast<size_t>(off_b) * a.c
                                   : tab + (KIND == kF32 ? off_b / 4 : off_b);
      acc = score_slice<KIND>(stage + b * stage_bytes + at,
                              (at >> 7) & sg.swz, min(sg.slice, rb - off_b),
                              t, a.c, acc);
    }
    if (j == ns - 1) {
      Key key = kEmpty;
      if (live) {
        const float score = KIND == kPq ? acc : my_sq - 2.0f * acc;
        if (isfinite(score)) {
          const int gc = c0 + c;
          key = scan_topk::make_key(
              score, static_cast<unsigned>(gc / ch_per_list) * a.max_len +
                         (gc % ch_per_list) * kRows + tid);
        }
      }
      full |= offer(key, buf, cap, sh, thr);
    }
    // the stage scored at s - 1 is free: every thread passed the barrier
    if (s + kStages - 1 < n_steps) issue(s + kStages - 1);
    if (!sg.tma) cp_commit();
    if (++j == ns) {
      j = 0;
      ++c;
    }
  }
  cp_wait<0>();
  __syncthreads();
  // this CTA's part: its exact k best alone, else at most k + 64 for rank
  // 0 to merge (their threshold is already near the k-th)
  if (sh.cnt > (cs > 1 ? k + kCutSlack : k))
    block_select(buf, sh.cnt, k, cs > 1 ? k + kCutSlack : k, sh);

  // Rank 0 gathers the other CTAs' parts over distributed shared memory,
  // kBatch keys a thread loaded at once, then offered a round at a time
  // (with a barrier and a cut between rounds unless all of them fit).
  if (cs > 1) {
    cluster.sync();
    if (rank == 0) {
      constexpr int kBatch = 8;
      int rn[kMaxCluster], total = 0;
      for (int r = 1; r < cs; ++r) {
        rn[r] = *cluster.map_shared_rank(&sh.cnt, r);
        total += rn[r];
      }
      const bool roomy = sh.cnt + total <= cap;
      for (int base = 0; base < total; base += kBatch * kThreads) {
        Key keys[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          int i = base + u * kThreads + tid;
          keys[u] = kEmpty;
          for (int r = 1; r < cs && i >= 0; ++r) {
            if (i < rn[r]) keys[u] = cluster.map_shared_rank(buf, r)[i];
            i -= rn[r];
          }
        }
        if (roomy) {
          thr = sh.thr;
#pragma unroll
          for (int u = 0; u < kBatch; ++u) offer(keys[u], buf, cap, sh, thr);
          __syncthreads();
          continue;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          thr = sh.thr;
          full = offer(keys[u], buf, cap, sh, thr);
          if (__syncthreads_or(full))
            block_select(buf, sh.cnt, k, k + kCutSlack, sh);
        }
      }
    }
    cluster.sync();             // the other CTAs' keys are read
    if (rank != 0) return;
    if (sh.cnt > k) block_select(buf, sh.cnt, k, k, sh);
  }

  // the k best in order, then (+inf, -1)
  const int n = sh.cnt;
  float* out_s = a.out_s + static_cast<size_t>(qi) * k;
  int* out_i = a.out_i + static_cast<size_t>(qi) * k;
  auto put = [&](int r, Key key) {
    const unsigned pos = static_cast<unsigned>(key);
    const int p = static_cast<int>(pos / a.max_len);
    const int slot = static_cast<int>(pos % a.max_len);
    const int lst = __ldg(probe_q + p);
    out_s[r] = scan_topk::key_score(key);
    out_i[r] = __ldg(a.lists + static_cast<size_t>(lst) * a.ld_lists + slot);
  };
  if (n <= 64) {
    if (tid < n) {
      const Key x = buf[tid];
      int r = 0;
      for (int i = 0; i < n; ++i) r += buf[i] < x;
      put(r, x);
    }
  } else {
    scan_topk::block_sort(buf, n);
    for (int r = tid; r < n; r += kThreads) put(r, buf[r]);
  }
  for (int r = n + tid; r < k; r += kThreads) {
    out_s[r] = CUDART_INF_F;
    out_i[r] = -1;
  }
}

// The cluster size of the last launch (for the chip log).
inline int& last_cluster() {
  static int r = 0;
  return r;
}

// The launch: the staging plan and (TMA) the slabs' tensor map, dynamic
// shared memory set once per device and size, and the cluster size chosen
// when the call leaves it 0: the fewest waves of clusters the card runs at
// once times (chunks a CTA scans + 2, a fixed cost: the loads before the
// first chunk, the selection and the merge), ties to the smaller cluster.
template <int KIND>
cudaError_t launch(const ListScanArgs& args) {
  static int smem_set[64];
  static int occ_smem[64][4], occ_n[64][4];
  if (args.k < 1 || args.nq < 1 || args.cluster < 0 ||
      args.cluster > kMaxCluster)
    return cudaErrorInvalidValue;
  // the last call's tensor map, reused while the slabs and plan are its
  static std::mutex map_mutex;
  static CUtensorMap map_cache;
  static const void* map_rows = nullptr;
  static long long map_key[3];
  ScanParams P;
  P.a = args;
  ListScanArgs& a = P.a;
  P.st = plan_stage(a);
  const long long key[3] = {row_bytes(a),
                            static_cast<long long>(a.n_lists) * a.max_len,
                            P.st.slice};
  std::lock_guard<std::mutex> lock(map_mutex);
  if (P.st.tma && map_rows == a.rows && key[0] == map_key[0] &&
      key[1] == map_key[1] && key[2] == map_key[2]) {
    P.map = map_cache;
  } else if (P.st.tma) {
    const sm90::EncodeTiled enc = sm90::encode_tiled();
    if (enc == nullptr) return cudaErrorNotSupported;
    // the slabs as (rows, row bytes) uint8; boxes of 256 rows x a slice
    const int rb = row_bytes(a);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(rb),
                                static_cast<cuuint64_t>(a.n_lists) * a.max_len};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(rb)};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(P.st.slice),
                               static_cast<cuuint32_t>(kRows)};
    const cuuint32_t unit[2] = {1, 1};
    const CUtensorMapSwizzle sw =
        P.st.slice == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
        : P.st.slice == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
        : P.st.slice == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                           : CU_TENSOR_MAP_SWIZZLE_NONE;
    if (enc(&P.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
            const_cast<void*>(a.rows), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
    map_cache = P.map;
    map_rows = a.rows;
    for (int i = 0; i < 3; ++i) map_key[i] = key[i];
  }
  auto kern = list_scan_kernel<KIND>;
  const int bytes = static_cast<int>(Layout(a, P.st).total);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  dev &= 63;
  if (bytes > smem_set[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    smem_set[dev] = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(a.stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (a.cluster == 0) {
    const int n_ch = a.n_probe * ((a.max_len + kRows - 1) / kRows);
    long long best = -1;
    a.cluster = 1;
    for (int i = 0; i <= 3; ++i) {
      const int r = 1 << i;
      if (r > 1 && r > n_ch) break;
      if (occ_smem[dev][i] != bytes) {
        cfg.gridDim = dim3(static_cast<unsigned>(r));
        attr[0].val.clusterDim.x = r;
        int n = 0;
        err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
        if (err != cudaSuccess) return err;
        occ_smem[dev][i] = bytes;
        occ_n[dev][i] = n;
      }
      const int act = occ_n[dev][i];
      if (act < 1) continue;
      const long long waves = (a.nq + act - 1) / act;
      const long long cost = waves * ((n_ch + r - 1) / r + 2);
      if (best < 0 || cost < best) {
        best = cost;
        a.cluster = r;
      }
    }
  }
  cfg.gridDim = dim3(static_cast<unsigned>(a.nq) * a.cluster);
  attr[0].val.clusterDim.x = a.cluster;
  last_cluster() = a.cluster;
  err = cudaLaunchKernelEx(&cfg, kern, P);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace list_scan
}  // namespace
