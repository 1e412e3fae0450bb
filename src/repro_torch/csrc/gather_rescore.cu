// The rescore ladder of progressive search in one launch, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `gather_rescore` of the JAX package
// (src/repro/kernels/gather_rescore.py) together with the top-k its callers
// run on its output, for every stage of a ladder at once.  Stage s scores
// each query's surviving candidate rows over their [:dim_s] prefix
// (score = |x|^2 - 2 q.x, the norm from a precomputed prefix-norm column or
// from the rows) and keeps the best k_s; stage s + 1 starts from those k_s
// in rank order.  A single step (`gather_rescore_topk`) is the one-stage
// case of the same kernel.
//
// Bound on an H100 SXM: the bytes.  At the flat serving dispatch (32
// queries, (C, dim, k) = (64,256,32) -> (32,512,16) -> (16,1024,10) ->
// (10,2048,10) -> (10,3584,10)) each surviving row is read once up to its
// deepest dim, about 7.5 MB: 2.2 us at 3.35 TB/s.  Five separate launches
// cost more than that in launch latency alone, and re-reading every prefix
// at each stage doubles the bytes.
//
// Design.  One thread-block cluster of R CTAs (R = 1..8, chosen by the
// wrapper so that R * Q fills the SMs) serves one query through every
// stage; nothing goes to device memory between stages.
//   * Survivors stay in shared memory, in rank order: (row id, the dot
//     product q.x and the norm |x|^2 so far).  Every CTA of the cluster
//     holds the same copy.
//   * A stage whose dim is larger than the previous stage's adds only
//     q.x over [dim_{s-1}, dim_s) to the carried dot (and |x|^2 to the
//     carried norm when the stage has no norm column); any other stage
//     starts from 0.
//   * The stage's new dims are cut into chunks of kChunk; (candidate,
//     chunk) items go round-robin to all warps of the cluster, and a warp
//     reduces its item with 16-byte loads and shuffles and stores the
//     partial sum into every CTA's shared memory (distributed shared
//     memory).  After a cluster barrier each CTA adds the chunk partials in
//     chunk order, so the arithmetic depends on the stage dims alone, never
//     on R or on which warp took an item: two launches, and any R, give
//     the same bits.
//   * Selection is an exact rank count over (score, position): candidate
//     c's rank is the number of candidates ordered before it.  Every CTA
//     holds the same scores, so each ranks all candidates of an
//     intermediate stage itself and keeps the survivors (rank < k) in its
//     own next buffer: one cluster barrier a stage, the one after the
//     partial sums (alternate stages use alternate partial buffers).  At
//     the last stage each CTA ranks every R-th candidate and writes its
//     survivors to the result.  A slot with no finite score carries id -1
//     and stays (+inf, -1) in every later stage, as the chained plain
//     steps give.
//   * The latency chain of a stage is short: a warp has two rows' chunks
//     in flight at once, validity is settled once when the ids are loaded,
//     and each candidate's norm column is fetched while the rows load.
// Per call the host packs one argument block (the per-stage dims, k and
// norm columns by value) and launches once.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;          // dims of one (candidate, chunk) item
constexpr int kMaxStages = 8;
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

// The kernel's arguments, packed by the wrapper (kernels/gather_rescore.py)
// into one block: one ctypes argument per call.
struct LadderArgs {
  const float* q;             // (nq, ld_q)
  const float* db;            // (n, ld_db)
  const int* cand;            // (nq, c) row ids, -1 = padding
  const float* sq;            // prefix norms (row stride ld_sq, column
                              // stride sq_cs), or null
  const uint8_t* valid;       // (n,) or null (every row valid)
  float* out_s;               // (nq, k of the last stage)
  int* out_i;
  void* stream;
  int ld_q, ld_db, ld_sq, sq_cs;
  int nq, n, c;
  int n_stages;
  int cluster;                // R, CTAs a query
  int vec;                    // 16-byte loads: dims, strides, pointers allow
  int nrm;                    // some stage computes its norm from the rows
  int b_cap;                  // entries of the second survivor buffer
  int p_cap;                  // entries of the partial-sum buffer
  int dim[kMaxStages];
  int k[kMaxStages];
  int sq_col[kMaxStages];     // column of sq for the stage, -1 = none
};

namespace {

__host__ __device__ inline size_t smem_bytes(const LadderArgs& a) {
  const int per = a.nrm ? 3 : 2;   // id, dot (and norm) a survivor
  return sizeof(float) * ((size_t)per * (a.c + a.b_cap) + a.c
                          + (size_t)2 * (a.nrm ? 2 : 1) * a.p_cap);
}

// q.x (and |x|^2) over [d0, d0 + len) of two rows (len <= kChunk; a row
// with len 0 reads nothing and sums 0), reduced across the warp: both
// rows' loads are in flight together.  Every lane returns the sums.
template <bool VEC, bool NRM>
__device__ __forceinline__ void chunk_dots(const float* __restrict__ qrow,
                                           const float* __restrict__ row_a,
                                           int da, int len_a,
                                           const float* __restrict__ row_b,
                                           int db, int len_b, int lane,
                                           float (&out)[4]) {
  float dot[2] = {0.f, 0.f}, nrm[2] = {0.f, 0.f};
  if (VEC) {
    constexpr int kV = kChunk / 128;
    float4 x[2][kV], y[2][kV];
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int d = 4 * (lane + 32 * i);
      x[0][i] = d < len_a ? __ldg(reinterpret_cast<const float4*>(row_a + da + d)) : zero;
      y[0][i] = d < len_a ? __ldg(reinterpret_cast<const float4*>(qrow + da + d)) : zero;
      x[1][i] = d < len_b ? __ldg(reinterpret_cast<const float4*>(row_b + db + d)) : zero;
      y[1][i] = d < len_b ? __ldg(reinterpret_cast<const float4*>(qrow + db + d)) : zero;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        dot[r] = fmaf(x[r][i].x, y[r][i].x, dot[r]);
        dot[r] = fmaf(x[r][i].y, y[r][i].y, dot[r]);
        dot[r] = fmaf(x[r][i].z, y[r][i].z, dot[r]);
        dot[r] = fmaf(x[r][i].w, y[r][i].w, dot[r]);
        if (NRM) {
          nrm[r] = fmaf(x[r][i].x, x[r][i].x, nrm[r]);
          nrm[r] = fmaf(x[r][i].y, x[r][i].y, nrm[r]);
          nrm[r] = fmaf(x[r][i].z, x[r][i].z, nrm[r]);
          nrm[r] = fmaf(x[r][i].w, x[r][i].w, nrm[r]);
        }
      }
  } else {
#pragma unroll 4
    for (int d = lane; d < max(len_a, len_b); d += 32) {
      const float xa = d < len_a ? __ldg(row_a + da + d) : 0.f;
      const float qa = d < len_a ? __ldg(qrow + da + d) : 0.f;
      const float xb = d < len_b ? __ldg(row_b + db + d) : 0.f;
      const float qb = d < len_b ? __ldg(qrow + db + d) : 0.f;
      dot[0] = fmaf(xa, qa, dot[0]);
      dot[1] = fmaf(xb, qb, dot[1]);
      if (NRM) {
        nrm[0] = fmaf(xa, xa, nrm[0]);
        nrm[1] = fmaf(xb, xb, nrm[1]);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dot[r] += __shfl_xor_sync(kFull, dot[r], off);
      if (NRM) nrm[r] += __shfl_xor_sync(kFull, nrm[r], off);
    }
  out[0] = dot[0];
  out[1] = nrm[0];
  out[2] = dot[1];
  out[3] = nrm[1];
}

// grid = nq * R CTAs in clusters of R; cluster qi serves query qi.
template <bool VEC, bool NRM>
__global__ void __launch_bounds__(kThreads)
rescore_ladder_kernel(const __grid_constant__ LadderArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int R = a.cluster;
  const int rank = (int)cluster.block_rank();
  const int qi = blockIdx.x / R;
  const int lane = threadIdx.x & 31;
  const int gw = rank * kWarps + (threadIdx.x >> 5);   // warp in the cluster
  const int n_gw = R * kWarps;

  // survivor buffers A (c entries) and B (b_cap): row id (-1 = no row),
  // dot, norm; the stage's scores; two chunk-partial buffers, used by
  // alternate stages
  float* p = smem;
  int* id_buf[2];
  float* dot_buf[2];
  float* nrm_buf[2];
  const int cap[2] = {a.c, a.b_cap};
  for (int b = 0; b < 2; ++b) {
    id_buf[b] = reinterpret_cast<int*>(p);
    dot_buf[b] = p + cap[b];
    nrm_buf[b] = p + 2 * cap[b];
    p += (NRM ? 3 : 2) * cap[b];
  }
  float* sc = p;
  float* part_base = sc + a.c;                  // [2][dot, norm][p_cap]

  // The candidates whose rows exist (id in [0, n), valid), packed in their
  // order: the rest score +inf at every stage, so they only ever fill the
  // result's tail, and ranking them would cost as much as the real ones
  // (the quantized backend's table is mostly an empty tail window).
  const float* qrow = a.q + (size_t)qi * a.ld_q;
  int* flag = reinterpret_cast<int*>(sc);       // free until stage 0 scores
  const int per = (a.c + kThreads - 1) / kThreads;
  const int i0 = min(a.c, (int)threadIdx.x * per), i1 = min(a.c, i0 + per);
  int mine = 0;
  for (int i = i0; i < i1; ++i) {
    const int id = a.cand[(size_t)qi * a.c + i];
    const bool ok = id >= 0 && id < a.n
                    && (a.valid == nullptr || a.valid[id] != 0);
    flag[i] = ok ? id : -1;
    mine += ok;
  }
  __shared__ int warp_total[kWarps];
  int incl = mine;                              // block-wide exclusive scan
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) warp_total[threadIdx.x >> 5] = incl;
  __syncthreads();
  int pos = incl - mine, cin = 0;
  for (int w = 0; w < kWarps; ++w) {
    pos += w < (int)(threadIdx.x >> 5) ? warp_total[w] : 0;
    cin += warp_total[w];
  }
  for (int i = i0; i < i1; ++i)
    if (flag[i] >= 0) id_buf[0][pos++] = flag[i];
  cluster.sync();      // the cluster runs, and every CTA holds the ids

  int cur = 0, prev_dim = 0;
  for (int s = 0; s < a.n_stages; ++s) {
    const int dim = a.dim[s], k = a.k[s], col = a.sq_col[s];
    const bool carry = prev_dim > 0 && dim > prev_dim;
    const int lo = carry ? prev_dim : 0;
    const int nch = (dim - lo + kChunk - 1) / kChunk;
    const int per_wave = max(1, a.p_cap / nch);
    int* cid = id_buf[cur];
    float* cdot = dot_buf[cur];
    float* cnrm = nrm_buf[cur];
    float* part = part_base + (s & 1) * (NRM ? 2 : 1) * a.p_cap;
    float* part_n = part + a.p_cap;

    for (int w0 = 0; w0 < cin; w0 += per_wave) {
      const int wn = min(per_wave, cin - w0);
      // this thread's first candidate's norm, fetched while the rows load
      float sq_first = 0.f;
      if (col >= 0 && threadIdx.x < wn && cid[w0 + threadIdx.x] >= 0)
        sq_first = __ldg(a.sq + (size_t)cid[w0 + threadIdx.x] * a.ld_sq
                         + (size_t)col * a.sq_cs);
      // (candidate, chunk) items, two a warp at a time
      for (int it = gw; it < wn * nch; it += 2 * n_gw) {
        const int it2 = it + n_gw;
        const int id_a = cid[w0 + it / nch];
        const int id_b = it2 < wn * nch ? cid[w0 + it2 / nch] : -1;
        const int da = lo + (it % nch) * kChunk;
        const int db = lo + (it2 % nch) * kChunk;
        const int len_a = id_a >= 0 ? min(dim, da + kChunk) - da : 0;
        const int len_b = id_b >= 0 ? min(dim, db + kChunk) - db : 0;
        if (len_a == 0 && len_b == 0) continue;          // warp-uniform
        float r[4];
        chunk_dots<VEC, NRM>(qrow, a.db + (size_t)max(id_a, 0) * a.ld_db, da,
                             len_a, a.db + (size_t)max(id_b, 0) * a.ld_db,
                             db, len_b, lane, r);
        if (lane < R) {                                  // lane t feeds CTA t
          float* pt = cluster.map_shared_rank(part, lane);
          if (len_a) pt[it] = r[0];
          if (len_b) pt[it2] = r[2];
          if (NRM) {
            if (len_a) pt[a.p_cap + it] = r[1];
            if (len_b) pt[a.p_cap + it2] = r[3];
          }
        }
      }
      cluster.sync();
      for (int cc = w0 + threadIdx.x; cc < w0 + wn; cc += kThreads) {
        const int id = cid[cc];
        float score = CUDART_INF_F;
        if (id >= 0) {
          float dot = carry ? cdot[cc] : 0.f;
          float nrm = (NRM && carry) ? cnrm[cc] : 0.f;
          const float* pd = part + (cc - w0) * nch;
          const float* pn = part_n + (cc - w0) * nch;
          for (int ch = 0; ch < nch; ++ch) {
            dot += pd[ch];
            if (NRM) nrm += pn[ch];
          }
          cdot[cc] = dot;
          if (NRM) cnrm[cc] = nrm;
          float norm = nrm;
          if (col >= 0)
            norm = cc == w0 + threadIdx.x
                       ? sq_first
                       : __ldg(a.sq + (size_t)id * a.ld_sq
                               + (size_t)col * a.sq_cs);
          score = norm - 2.0f * dot;
          if (!(score == score)) score = CUDART_INF_F;   // NaN ranks last
        }
        sc[cc] = score;
      }
      if (w0 + wn < cin) cluster.sync();   // the partials are written again
    }
    __syncthreads();

    // Rank count.  The last stage's survivors go to the result, every R-th
    // candidate ranked by this CTA; an earlier stage's go to this CTA's own
    // next buffer, every candidate ranked by every CTA (the same scores
    // give the same ranks everywhere, so no CTA waits for another).
    const bool last = s == a.n_stages - 1;
    const int nxt = cur ^ 1;
    const int c0 = last ? threadIdx.x * R + rank : threadIdx.x;
    const int step = last ? kThreads * R : kThreads;
    if (last)                 // ranks no candidate reaches: (+inf, -1)
      for (int r = cin + c0; r < k; r += step) {
        a.out_s[(size_t)qi * k + r] = CUDART_INF_F;
        a.out_i[(size_t)qi * k + r] = -1;
      }
    for (int cc = c0; cc < cin; cc += step) {
      const float v = sc[cc];
      int r = 0;
      for (int j = 0; j < cin; ++j) {
        const float t = sc[j];
        r += (t < v) || (t == v && j < cc);
      }
      if (r >= k) continue;
      const int id = v < CUDART_INF_F ? cid[cc] : -1;
      if (last) {
        a.out_s[(size_t)qi * k + r] = v;
        a.out_i[(size_t)qi * k + r] = id;
      } else {
        id_buf[nxt][r] = id;
        dot_buf[nxt][r] = cdot[cc];
        if (NRM) nrm_buf[nxt][r] = cnrm[cc];
      }
    }
    if (last) break;
    __syncthreads();
    cur = nxt;
    cin = min(k, cin);
    prev_dim = dim;
  }
  // A CTA's last access to another's shared memory is before the last
  // cluster barrier it passes, so each may exit on its own.
}

// The dynamic shared memory each kernel may take, per device (set when a
// launch needs more; a launch above it is refused).
int smem_set[64][4];

template <bool VEC, bool NRM>
cudaError_t launch(const LadderArgs& a) {
  auto kern = rescore_ladder_kernel<VEC, NRM>;
  const int bytes = (int)smem_bytes(a);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int& set = smem_set[dev & 63][VEC * 2 + NRM];
  if (bytes > set) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    set = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.nq * a.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(a.stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch of the whole ladder described by the LadderArgs block at
// `args`.  Returns the launch's CUDA error.
int rescore_ladder_launch(const void* args) {
  const LadderArgs& a = *static_cast<const LadderArgs*>(args);
  if (a.n_stages < 1 || a.n_stages > kMaxStages || a.cluster < 1
      || a.cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (a.vec && a.nrm)
    err = launch<true, true>(a);
  else if (a.vec)
    err = launch<true, false>(a);
  else if (a.nrm)
    err = launch<false, true>(a);
  else
    err = launch<false, false>(a);
  return (int)err;
}

int rescore_ladder_args_size() { return (int)sizeof(LadderArgs); }

// Human-readable name of a CUDA error code returned by the launcher.
const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
