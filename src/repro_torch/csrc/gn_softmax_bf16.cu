// The GN softmax (gn_softmax.cuh) over bf16 scores.
#define GN_SOFTMAX_T __nv_bfloat16
#include "gn_softmax.cuh"
