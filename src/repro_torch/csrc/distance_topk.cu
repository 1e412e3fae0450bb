// Stage-0 fused truncated-L2 scan with top-k, float32 rows: the body is
// distance_topk.cuh (its header comment is the kernel's note).

#define L2_ELEM float
#include "distance_topk.cuh"
