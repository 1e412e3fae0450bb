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
// Design: a row-balanced partition (the merge-path CSR reduction of
// Merrill & Garland, "Merge-based Parallel Sparse Matrix-Vector
// Multiplication", SC 2016).  The work is the merged list of the N
// segment ends and the rows; a task is `items` consecutive entries of it,
// and each warp owns one task, so every warp gets the same share of rows
// plus segments whatever the degrees (a power-law graph's hubs hold 20,000
// to 30,000 rows against a mean of 25; a warp per segment left one warp
// streaming a hub at about 2 GB/s).  Three launches:
//   1. segment_sum_partition: the (segments finished, rows consumed) point
//      where each task starts, by a binary search of indptr on the device
//      (no host sync: the grid is sized by the row count, and tasks past
//      the real end have nothing to do).
//   2. segment_sum_wide (D > 4) or segment_sum_narrow (D <= 4): a warp
//      sums its task's rows.  Segments that begin and end inside the task
//      are written straight out; the one still open at the task's end
//      leaves its partial (sum, error) as the task's carry, and the one
//      that began in an earlier task and ends here leaves its part as the
//      task's head, both unrounded, in a per-call workspace.
//      - wide: lanes across the columns (16-byte loads, G lanes a row,
//        32 / G rows a step), up to 8 steps of loads in flight, a shuffle
//        butterfly across the row groups per segment;
//      - narrow: lanes across the rows (16 rows a lane at D = 1, 8 at
//        D = 2, 3, 4 at D = 4; 16-byte loads where the rows are packed, the
//        next step's rows in flight while a step is summed), runs of one
//        segment summed in registers and a segmented warp scan keyed on
//        the segment of each lane's last run, so a segment of 25 rows
//        costs a few register adds instead of a butterfly.
//   3. segment_sum_fixup: a segment whose rows span tasks t_a .. t_f - 1
//      and ends in task t_f is the carries of those tasks plus the head of
//      t_f, added in task order and rounded once, by the warp of task t_a
//      (t_a and t_f follow from indptr alone).
// No float atomics: the order of every addition is fixed by indptr, so
// the result is deterministic.  The accumulation is compensated: every add
// is an error-free TwoSum whose rounding error goes to a second register
// (cascaded summation, Ogita-Rump-Oishi Sum2), and the butterflies, the
// scan, the carries and the fix-up merge (sum, error) pairs the same way,
// so a segment's result is about as accurate as a float64 sum rounded
// once (rounding a spanning segment's parts before the fix-up moved
// EGNN's logits a thousand times further from the float64 sums).  Plain float32 accumulation lost up to 1.7e-4 of a segment's sum
// of |x| on EGNN's ogbn-products messages, where tens of thousands of small
// terms meet one large one.  indptr is clamped (indptr[N] to [0, n_rows],
// the others to [0, indptr[N]]), so a wrong pointer cannot read outside
// the live rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;                 // wide: row steps in flight
constexpr int kWideItems = 512;            // entries of a task (most), wide
constexpr int kNarrowItems = 1024;         // ... and narrow
constexpr unsigned kFull = 0xffffffffu;

// s + e == a + b exactly (Knuth's TwoSum; no multiply, so nothing for the
// compiler to contract, and no reassociation without fast-math).
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  const float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

// (s, e) += (b, f): a compensated pair added to a compensated pair.
__device__ __forceinline__ void add_pair(float& s, float& e, float b, float f) {
  float lost;
  two_sum(s, b, s, lost);
  e = (e + f) + lost;
}

// An infinite sum has no lost part.
__device__ __forceinline__ float result(float s, float e) {
  return isfinite(s) ? s + e : s;
}

// Row pointer i clamped to [0, lim].
__device__ __forceinline__ int ptr_at(const int* __restrict__ indptr, int i,
                                      int lim) {
  return min(max(__ldg(indptr + i), 0), lim);
}

// The task's corner points on the merge path: segments [i0, i1] touched,
// rows [j0, j1) consumed; segments i0 .. i1 - 1 end inside the task.
struct Task {
  int i0, i1, j0, j1;
};

__device__ __forceinline__ Task task_at(const int* __restrict__ bounds, int t,
                                        int items, long long total) {
  const long long d0 = min((long long)t * items, total);
  const long long d1 = min(d0 + items, total);
  Task k;
  k.i0 = bounds[t];
  k.i1 = bounds[t + 1];
  k.j0 = (int)(d0 - k.i0);
  k.j1 = (int)(d1 - k.i1);
  return k;
}

// 1. bounds[b] = the segments finished among the first min(b * items,
// N + nnz) entries of the merged list of segment ends and rows.
__global__ void __launch_bounds__(kThreads)
segment_sum_partition(const int* __restrict__ indptr, int n_seg, int n_rows,
                      int items, int n_bounds, int* __restrict__ bounds) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= n_bounds) return;
  const int nnz = ptr_at(indptr, n_seg, n_rows);
  const long long diag = min((long long)b * items, (long long)n_seg + nnz);
  int lo = (int)max(0LL, diag - nnz), hi = (int)min(diag, (long long)n_seg);
  while (lo < hi) {         // segment mid's end comes before entry diag?
    const int mid = (lo + hi) >> 1;
    if (ptr_at(indptr, mid + 1, nnz) <= diag - 1 - mid) lo = mid + 1;
    else hi = mid;
  }
  bounds[b] = lo;
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

// 2a. D > 4: lanes across the columns.
template <int VW>
__global__ void __launch_bounds__(kThreads)
segment_sum_wide(const float* __restrict__ data, const int* __restrict__ indptr,
                 const int* __restrict__ bounds, float* __restrict__ out,
                 float* __restrict__ carry, int n_seg, int n_rows, int d,
                 long long ld, int group, int items, int n_tasks) {
  // the task's row pointers p(i0) .. p(i1), so a segment's rows are
  // requested without first waiting on a global load of its end
  __shared__ int s_ptr[kWarps][kWideItems + 1];
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= n_tasks) return;                  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int r = lane / group, col = lane % group, rows = 32 / group;
  const int nnz = ptr_at(indptr, n_seg, n_rows);
  const Task k = task_at(bounds, t, items, (long long)n_seg + nnz);
  const int n_vec = d / VW;
  float* crow = carry + (size_t)t * 4 * d;     // carry, then head
  int* const sp = s_ptr[threadIdx.x >> 5] - k.i0;     // sp[s] = p(s)
  for (int s = k.i0 + lane; s <= k.i1; s += 32) sp[s] = ptr_at(indptr, s, nnz);
  __syncwarp();
  const bool split_head = sp[k.i0] < k.j0;      // i0 began in an earlier task

  // segments that end in this task without a row in it get their own part,
  // 0, from all lanes at once (a graph with many empty segments would
  // otherwise take a butterfly for each)
  for (int x = lane; x < (k.i1 - k.i0) * d; x += 32) {
    const int s = k.i0 + x / d;
    if (sp[s + 1] <= max(sp[s], k.j0)) out[(size_t)s * d + x % d] = 0.f;
  }

  int rb = max(sp[k.i0], k.j0);
  for (int s = k.i0; s <= k.i1 && s < n_seg; ++s) {   // warp-uniform
    const int pe = s < k.i1 ? sp[s + 1] : k.j1;
    const int re = max(pe, rb);
    const bool whole = s < k.i1 && !(s == k.i0 && split_head);
    if (re == rb && whole) continue;          // written above
    for (int c0 = 0; c0 < n_vec; c0 += group) {
      const int c = c0 + col;
      float acc[VW], err[VW];                 // running sum, its lost part
#pragma unroll
      for (int v = 0; v < VW; ++v) acc[v] = err[v] = 0.f;
      if (c < n_vec) {
        const float* base = data + (long long)c * VW;
        for (int e = rb + r; e < re; e += kUnroll * rows) {
          float x[kUnroll][VW];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int row = e + u * rows;
            if (row < re) {
              load_row<VW>(base + (long long)row * ld, x[u]);
            } else {
#pragma unroll
              for (int v = 0; v < VW; ++v) x[u][v] = 0.f;
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
#pragma unroll
            for (int v = 0; v < VW; ++v) {
              float lost;
              two_sum(acc[v], x[u][v], acc[v], lost);
              err[v] += lost;
            }
        }
      }
      // both lanes of a pair compute the same pair sum (TwoSum's error is
      // exact whatever the order), so every lane ends with the same value
      for (int off = group; off < 32; off <<= 1)
#pragma unroll
        for (int v = 0; v < VW; ++v) {
          const float s2 = __shfl_xor_sync(kFull, acc[v], off);
          const float e2 = __shfl_xor_sync(kFull, err[v], off);
          add_pair(acc[v], err[v], s2, e2);
        }
      if (r == 0 && c < n_vec) {
        if (whole) {                          // began and ends here
          float* orow = out + (size_t)s * d + c * VW;
          if constexpr (VW == 4) {
            *reinterpret_cast<float4*>(orow) =
                make_float4(result(acc[0], err[0]), result(acc[1], err[1]),
                            result(acc[2], err[2]), result(acc[3], err[3]));
          } else {
            orow[0] = result(acc[0], err[0]);
          }
        } else {                              // the carry or the head
          float* rec = crow + (s < k.i1 ? 2 * d : 0);
#pragma unroll
          for (int v = 0; v < VW; ++v) {
            rec[c * VW + v] = acc[v];
            rec[d + c * VW + v] = err[v];
          }
        }
      }
    }
    rb = re;
  }
}

// 2b. D <= 4: lanes across the rows.
template <int D>
__global__ void __launch_bounds__(kThreads)
segment_sum_narrow(const float* __restrict__ data,
                   const int* __restrict__ indptr,
                   const int* __restrict__ bounds, float* __restrict__ out,
                   float* __restrict__ carry, int n_seg, int n_rows,
                   long long ld, int vec, int items, int n_tasks) {
  // rows a lane takes a step (whole 16-byte words): the per-step search and
  // scan are most of the work, so a step takes as many rows as it can
  constexpr int V = D == 1 ? 16 : D == 4 ? 4 : 8;
  constexpr int kChunk = 32 * V;             // rows a warp takes per step
  // the task's row pointers p(i0) .. p(i1) (i1 - i0 <= items), so the
  // searches below read shared memory, not a chain of global loads
  __shared__ int s_ptr[kWarps][kNarrowItems + 1];
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= n_tasks) return;
  const int lane = threadIdx.x & 31;
  const int nnz = ptr_at(indptr, n_seg, n_rows);
  const Task k = task_at(bounds, t, items, (long long)n_seg + nnz);
  int* const sp = s_ptr[threadIdx.x >> 5] - k.i0;     // sp[s] = p(s)
  for (int s = k.i0 + lane; s <= k.i1; s += 32) sp[s] = ptr_at(indptr, s, nnz);
  __syncwarp();
  float* const crow = carry + (size_t)t * 4 * D;  // carry, then head
  const bool split_head = sp[k.i0] < k.j0;      // i0 began in an earlier task
  // segment s ends in this task with sum (S, E): out, or the head record
  // when it began in an earlier task (the fix-up rounds it with the rest)
  auto emit = [&](int s, const float* S, const float* E) {
    if (s == k.i0 && split_head) {
#pragma unroll
      for (int c = 0; c < D; ++c) {
        crow[2 * D + c] = S[c];
        crow[3 * D + c] = E[c];
      }
    } else {
#pragma unroll
      for (int c = 0; c < D; ++c) out[(size_t)s * D + c] = result(S[c], E[c]);
    }
  };
  const float zero[D] = {};

  // segments that end in this task without a row in it (empty ones, or
  // one whose rows all lie in earlier tasks) get their own part, 0
  for (int s = k.i0 + lane; s < k.i1; s += 32)
    if (sp[s + 1] <= max(sp[s], k.j0)) emit(s, zero, zero);

  int cseg = -1;                             // the carry between steps
  float cs[D], ce[D];
#pragma unroll
  for (int c = 0; c < D; ++c) cs[c] = ce[c] = 0.f;

  // rows c0 + V lane .. of a step into x (0 outside the task's rows)
  auto load = [&](int c0, float (&x)[V][D]) {
    const int r0 = c0 + V * lane;
    const int first = max(r0, k.j0), last = min(r0 + V - 1, k.j1 - 1);
    if (vec && r0 + V <= nnz) {              // packed rows, 16-byte aligned
      const float4* p4 = reinterpret_cast<const float4*>(data + (size_t)r0 * D);
#pragma unroll
      for (int q = 0; q < V * D / 4; ++q) {
        const float4 f = __ldg(p4 + q);
        const float w[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) x[(4 * q + m) / D][(4 * q + m) % D] = w[m];
      }
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int row = r0 + u;
        const bool ok = row >= first && row <= last;
#pragma unroll
        for (int c = 0; c < D; ++c)
          x[u][c] = ok ? __ldg(data + (long long)row * ld + c) : 0.f;
      }
    }
  };

  const int c_begin = k.j0 < k.j1 ? k.j0 - k.j0 % V : k.j1;
  float xn[V][D];                            // the next step's rows, in flight
  if (c_begin < k.j1) load(c_begin, xn);
  for (int c0 = c_begin; c0 < k.j1; c0 += kChunk) {   // warp-uniform
    const int r0 = c0 + V * lane;
    const int first = max(r0, k.j0), last = min(r0 + V - 1, k.j1 - 1);
    const bool any = first <= last;
    float x[V][D];
#pragma unroll
    for (int u = 0; u < V; ++u)
#pragma unroll
      for (int c = 0; c < D; ++c) x[u][c] = xn[u][c];
    if (c0 + kChunk < k.j1) load(c0 + kChunk, xn);
    // the segment of the first row: segments ending at or before it come
    // earlier (a binary search over the task's segment ends)
    int cur = k.i1;
    if (any) {
      int lo = k.i0, hi = k.i1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sp[mid + 1] <= first) lo = mid + 1;
        else hi = mid;
      }
      cur = lo;
    } else if (r0 + V - 1 < k.j0) {
      cur = -1;                              // a lane before the task's rows
    }
    const int s_first = cur;
    bool head = false;                       // s_first ends in this lane
    float hs[D], he[D], ts[D], te[D];        // head run, current run
#pragma unroll
    for (int c = 0; c < D; ++c) hs[c] = he[c] = ts[c] = te[c] = 0.f;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int row = r0 + u;
      if (row < first || row > last) continue;
      int ns = cur;
      while (ns < k.i1 && sp[ns + 1] <= row) ++ns;
      if (ns != cur) {                       // the run of `cur` has ended
        if (cur == s_first) {
          head = true;
#pragma unroll
          for (int c = 0; c < D; ++c) { hs[c] = ts[c]; he[c] = te[c]; }
        } else {                             // began and ended in this lane
#pragma unroll
          for (int c = 0; c < D; ++c)
            out[(size_t)cur * D + c] = result(ts[c], te[c]);
        }
#pragma unroll
        for (int c = 0; c < D; ++c) ts[c] = te[c] = 0.f;
        cur = ns;
      }
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float lost;
        two_sum(ts[c], x[u][c], ts[c], lost);
        te[c] += lost;
      }
    }
    // the carry from the previous step joins lane 0's first run
    if (lane == 0 && cseg >= 0 && cseg == s_first) {
#pragma unroll
      for (int c = 0; c < D; ++c) {
        if (head) add_pair(hs[c], he[c], cs[c], ce[c]);
        else add_pair(ts[c], te[c], cs[c], ce[c]);
      }
    }
    // segmented inclusive scan of the last runs, keyed on their segment
    // (keys never decrease across the lanes, so equal keys are contiguous)
    for (int off = 1; off < 32; off <<= 1) {
      const int ku = __shfl_up_sync(kFull, cur, off);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float su = __shfl_up_sync(kFull, ts[c], off);
        const float eu = __shfl_up_sync(kFull, te[c], off);
        if (lane >= off && ku == cur) add_pair(ts[c], te[c], su, eu);
      }
    }
    const int kp = __shfl_up_sync(kFull, cur, 1);
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const float s_up = __shfl_up_sync(kFull, ts[c], 1);
      const float e_up = __shfl_up_sync(kFull, te[c], 1);
      if (head && lane > 0 && kp == s_first) add_pair(hs[c], he[c], s_up, e_up);
    }
    if (head) emit(s_first, hs, he);
    if (any && cur < k.i1 && sp[cur + 1] == last + 1)
      emit(cur, ts, te);                        // the last run ends here
    cseg = __shfl_sync(kFull, cur, 31);
#pragma unroll
    for (int c = 0; c < D; ++c) {
      cs[c] = __shfl_sync(kFull, ts[c], 31);
      ce[c] = __shfl_sync(kFull, te[c], 31);
    }
  }
  if (lane == 0 && k.i1 < n_seg) {
    const bool mine = cseg == k.i1;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      crow[c] = mine ? cs[c] : 0.f;
      crow[D + c] = mine ? ce[c] : 0.f;
    }
  }
}

// 3. The segment still open at the end of task t, if t is the first task
// that holds rows of it: the carries of tasks t .. t_f - 1 and the head of
// its ending task t_f, added in task order and rounded once.
__global__ void __launch_bounds__(kThreads)
segment_sum_fixup(const int* __restrict__ indptr,
                  const int* __restrict__ bounds,
                  const float* __restrict__ carry, float* __restrict__ out,
                  int n_seg, int n_rows, int d, int items, int n_tasks) {
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= n_tasks) return;
  const int lane = threadIdx.x & 31;
  const int s = bounds[t + 1];
  if (s >= n_seg) return;
  const int nnz = ptr_at(indptr, n_seg, n_rows);
  const long long ta = ((long long)s + ptr_at(indptr, s, nnz)) / items;
  const long long tf = ((long long)s + ptr_at(indptr, s + 1, nnz)) / items;
  if (ta != t || tf <= t || tf >= n_tasks) return;
  for (int c = lane; c < d; c += 32) {
    float S = 0.f, E = 0.f;
    long long u = t;
    for (; u + 8 <= tf; u += 8) {               // eight loads in flight
      float cs[8], ce[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        cs[m] = carry[(u + m) * 4 * d + c];
        ce[m] = carry[(u + m) * 4 * d + d + c];
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) add_pair(S, E, cs[m], ce[m]);
    }
    for (; u < tf; ++u)
      add_pair(S, E, carry[u * 4 * d + c], carry[u * 4 * d + d + c]);
    add_pair(S, E, carry[tf * 4 * d + 2 * d + c], carry[tf * 4 * d + 3 * d + c]);
    out[(size_t)s * d + c] = result(S, E);
  }
}

cudaError_t launch_main(const float* data, const int* indptr,
                        const int* bounds, float* out, float* carry,
                        int n_seg, int n_rows, int d, long long ld, int vec,
                        int items, int n_tasks, cudaStream_t st) {
  const int blocks = (n_tasks + kWarps - 1) / kWarps;
  if (d <= 4) {
    if (items > kNarrowItems) return cudaErrorInvalidValue;
    switch (d) {
#define SEG_NARROW(DD)                                                    \
  case DD:                                                                \
    segment_sum_narrow<DD><<<blocks, kThreads, 0, st>>>(                  \
        data, indptr, bounds, out, carry, n_seg, n_rows, ld, vec, items,  \
        n_tasks);                                                         \
    break;
      SEG_NARROW(1) SEG_NARROW(2) SEG_NARROW(3) SEG_NARROW(4)
#undef SEG_NARROW
      default:
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
  }
  if (items > kWideItems) return cudaErrorInvalidValue;
  const int vw = vec ? 4 : 1, n_vec = d / vw;
  int group = 1;
  while (group < n_vec && group < 32) group <<= 1;
  if (vec)
    segment_sum_wide<4><<<blocks, kThreads, 0, st>>>(
        data, indptr, bounds, out, carry, n_seg, n_rows, d, ld, group, items,
        n_tasks);
  else
    segment_sum_wide<1><<<blocks, kThreads, 0, st>>>(
        data, indptr, bounds, out, carry, n_seg, n_rows, d, ld, group, items,
        n_tasks);
  return cudaGetLastError();
}


// --------------------------------------------------------------- backward --
//
// segment_sum_backward: the gradient of the rows, d_data (n_rows, d)
// float32: each live row gets its segment's d_out row, the rows outside
// every segment (past the clamped indptr[N], or before indptr[0]) 0.  The
// JAX package has no backward kernel (it trains through
// jax.ops.segment_sum, src/repro/models/egnn.py:89-97, whose transpose is
// this gather).  A warp a task of 32 consecutive rows: each lane finds its
// row's segment by a binary search of indptr, clamped as the forward
// clamps it, so a hub's rows spread over many warps; then the warp copies
// the rows' d_out rows out, 16-byte words (several rows a step where D / 4
// divides 32), lanes across the columns; at D <= 4 a lane a row.  No
// arithmetic: the result is d_out's bits.

__device__ __forceinline__ int clamped_ptr(const int* indptr, int s,
                                           int nnz) {
  return min(max(__ldg(indptr + s), 0), nnz);
}

__global__ void __launch_bounds__(kThreads)
segment_sum_backward_kernel(const float* __restrict__ d_out,
                            const int* __restrict__ indptr, float* d_data,
                            int n_seg, int n_rows, int d, long long ld,
                            int vec) {
  const long long task =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long r0 = task * 32;
  if (r0 >= n_rows) return;
  const int nnz = min(max(__ldg(indptr + n_seg), 0), n_rows);
  const long long r = r0 + lane;
  int seg = -1;
  if (r < nnz && n_seg > 0) {
    int lo = 0, hi = n_seg;             // the last s with ptr[s] <= r
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (clamped_ptr(indptr, mid, nnz) <= r) lo = mid; else hi = mid;
    }
    if (clamped_ptr(indptr, lo, nnz) <= r) seg = lo;
  }
  if (d <= 4) {
    if (r < n_rows)
      for (int c = 0; c < d; ++c)
        d_data[r * ld + c] = seg >= 0 ? __ldg(d_out + static_cast<long long>(seg) * d + c) : 0.f;
    return;
  }
  const int n_here = static_cast<int>(min(32LL, n_rows - r0));
  if (vec) {
    const int w4 = d >> 2;              // 16-byte words a row
    const int per = (w4 <= 32 && (32 % w4) == 0) ? 32 / w4 : 1;
    const int sub = per > 1 ? lane / w4 : 0;
    const int c0 = per > 1 ? lane % w4 : lane;
    for (int k = 0; k < 32; k += per) {
      const int kr = k + sub;
      const int s = __shfl_sync(0xffffffffu, seg, kr & 31);
      if (kr >= n_here) continue;
      float4* dst = reinterpret_cast<float4*>(d_data + (r0 + kr) * ld);
      const float4* src =
          reinterpret_cast<const float4*>(d_out + static_cast<long long>(s) * d);
      for (int c = c0; c < w4; c += (per > 1 ? w4 : 32))
        dst[c] = s >= 0 ? __ldg(src + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int k = 0; k < n_here; ++k) {
      const int s = __shfl_sync(0xffffffffu, seg, k);
      float* dst = d_data + (r0 + k) * ld;
      for (int c = lane; c < d; c += 32)
        dst[c] = s >= 0 ? __ldg(d_out + static_cast<long long>(s) * d + c) : 0.f;
    }
  }
}

}  // namespace

extern "C" {

// data: (n_rows, d) float32, unit stride on d, row stride ld elements,
// sorted by segment; indptr: (n_seg + 1,) int32 row pointers; out: (n_seg,
// d) float32 contiguous; bounds: (n_tasks + 1,) int32 and carry: (n_tasks,
// 4, d) float32 workspace (a task's carry and head, sums and errors), n_tasks = ceil((n_seg + n_rows) / items).  vec
// != 0 selects 16-byte loads: for d > 4, d and ld multiples of 4; for
// d <= 4, packed rows (ld == d); data 16-byte aligned either way.  Returns
// the first CUDA error of the three launches.
int segment_sum_launch(const float* data, const int* indptr, float* out,
                       int* bounds, float* carry, int n_seg, int n_rows,
                       int d, long long ld, int vec, int items, int n_tasks,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = n_tasks + 1;
  segment_sum_partition<<<(nb + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      indptr, n_seg, n_rows, items, nb, bounds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_main(data, indptr, bounds, out, carry, n_seg, n_rows, d, ld,
                    vec, items, n_tasks, st);
  if (err != cudaSuccess) return (int)err;
  segment_sum_fixup<<<(n_tasks + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      indptr, bounds, carry, out, n_seg, n_rows, d, items, n_tasks);
  return (int)cudaGetLastError();
}

// The rows' gradient: d_data (n_rows, d) float32, row stride ld elements,
// unit stride on d; d_out (n_seg, d) float32 contiguous; indptr (n_seg +
// 1,) int32 as the forward took it.  vec != 0 selects 16-byte words (d and
// ld multiples of 4, both pointers 16-byte aligned).  Returns the launch's
// CUDA error.
int segment_sum_backward_launch(const float* d_out, const int* indptr,
                                float* d_data, int n_seg, int n_rows, int d,
                                long long ld, int vec, void* stream) {
  if (n_rows < 1 || d < 1 || n_seg < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long warps = (static_cast<long long>(n_rows) + 31) / 32;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  segment_sum_backward_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      d_out, indptr, d_data, n_seg, n_rows, d, ld, vec);
  return static_cast<int>(cudaGetLastError());
}

// Human-readable name of a CUDA error code returned by the launcher.
const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
