// The GN softmax (gn_softmax.cuh) over f32 scores.
#define GN_SOFTMAX_T float
#include "gn_softmax.cuh"
