// Stage-0 fused truncated-L2 scan with top-k, bf16 rows (the staged
// index's stage-0 block): the body is distance_topk.cuh, instantiated here
// for __nv_bfloat16 so it compiles beside the float32 library.

#include <cuda_bf16.h>

#define L2_ELEM __nv_bfloat16
#include "distance_topk.cuh"
