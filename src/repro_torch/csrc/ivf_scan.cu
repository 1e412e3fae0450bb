// IVF stage 0 over list-major float32 / int8 member slabs, for Hopper
// (sm_90a): one launch a call.
//
// Replaces the TPU kernel `ivf_scan_topk` of the JAX package
// (src/repro/kernels/ivf_scan.py: wrapper :275, `_ivf_scan_call` :227,
// `pallas_call` :243, body `_kernel` :182).  For each query the live
// members of its n_probe probed lists are scored `sq - 2 q.x` at the
// stage-0 dim and the k best kept.  Member rows are float32 or
// per-dimension int8 codes; for int8 the kernel folds the query onto the
// codes' grid in its prologue and widens each code to float, accumulating
// in float32.  (The TPU kernel multiplies the int8 rows as bfloat16 at the
// MXU's default precision; the results the port is held to are the JAX
// package's CPU / interpret ones, which are float32 throughout — as this
// kernel is.)  A row's dot product is one FMA chain in dim order, starting
// from its first product; `ivf_scan.ivf_scan_mirror` repeats it on the CPU.
//
// The kernel body, its bound and its design: list_scan.cuh (shared with
// the list-major PQ scan of pq_scan.cu).

#include "list_scan.cuh"

extern "C" {

// One call described by the ListScanArgs block at `args` (kind 0: float32
// slabs, 1: int8 slabs).  Returns the launch's CUDA error.
int ivf_scan_topk_launch(const void* args) {
  const ListScanArgs& a = *static_cast<const ListScanArgs*>(args);
  cudaError_t err = cudaErrorInvalidValue;
  if (a.kind == list_scan::kF32)
    err = list_scan::launch<list_scan::kF32>(a);
  else if (a.kind == list_scan::kInt8)
    err = list_scan::launch<list_scan::kInt8>(a);
  return static_cast<int>(err);
}

// Size of ListScanArgs, for the wrapper to check its packing against.
int list_scan_args_size() { return static_cast<int>(sizeof(ListScanArgs)); }

// CTAs a query of the last launch.
int list_scan_last_cluster() { return list_scan::last_cluster(); }

// Human-readable name of a CUDA error code returned by the launcher.
const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
