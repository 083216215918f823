// GN LayerNorm / RMSNorm (CoRN-LN) for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/gn_layernorm/kernel.py
// (_gn_layernorm_kernel, gn_layernorm_pallas).  Per row: the mean square
// (RMS) or the centred variance, accumulated in f32 and taken as sum * (1/C)
// like the Pallas kernel; then the CoRN rsqrt of var + 1e-8; then x gamma
// (+ beta).  The serving tick runs it 2L+1 times (ln1, ln2 per layer, the
// final norm) on (rows, d_model) activations.
//
// Bound: bytes.  One row is a few KB and needs a handful of flops per byte,
// so the card's memory rate is the limit.  This first version is the simple
// one: one block of 256 threads per row, a deterministic block reduction,
// and x read twice (the second read hits L1/L2).  Keeping the row in
// registers and giving a block several rows is later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Sum of one float per thread over the block, in a fixed order; every thread
// gets the total.  `red` holds kThreads / 32 + 1 floats.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (kThreads >> 5) ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[kThreads >> 5] = t;
  }
  __syncthreads();
  const float total = red[kThreads >> 5];
  __syncthreads();  // red is reused by the next call
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_layernorm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const float* __restrict__ lut,
                    T* __restrict__ y, int cols, float inv_c, int subtract_mean,
                    int mantissa_bits, int iters, float inv_sqrt2) {
  __shared__ float red[kThreads / 32 + 1];
  const T* xr = x + (size_t)blockIdx.x * cols;
  T* yr = y + (size_t)blockIdx.x * cols;

  // stage (i): moments in f32, divided by the true C
  float mu = 0.0f;
  if (subtract_mean) {
    float s = 0.0f;
    for (int i = threadIdx.x; i < cols; i += kThreads) s += gn::to_float(xr[i]);
    mu = block_sum(s, red) * inv_c;
  }
  float ss = 0.0f;
  for (int i = threadIdx.x; i < cols; i += kThreads) {
    const float c = gn::to_float(xr[i]) - mu;
    ss += c * c;
  }
  const float var = block_sum(ss, red) * inv_c;

  // stage (ii): CoRN rsqrt, then the multiply-only output stage
  const float rstd = gn::corn_rsqrt(var + 1e-8f, lut, mantissa_bits, iters, inv_sqrt2);
  for (int i = threadIdx.x; i < cols; i += kThreads) {
    float v = (gn::to_float(xr[i]) - mu) * rstd * gamma[i];
    if (beta != nullptr) v = v + beta[i];
    yr[i] = gn::from_float<T>(v);
  }
}

}  // namespace

// x, y: (rows, cols) contiguous, f32 (dtype 0) or bf16 (dtype 1); gamma, beta:
// (cols,) f32, beta may be null; lut: the (1 << mantissa_bits,) f32 CoRN table.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int gn_layernorm_launch(const void* x, const void* gamma, const void* beta,
                                   const void* lut, void* y, int rows, int cols,
                                   float inv_c, int dtype, int subtract_mean,
                                   int mantissa_bits, int iters, float inv_sqrt2,
                                   void* stream) {
  if (rows > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* g = static_cast<const float*>(gamma);
    const float* b = static_cast<const float*>(beta);
    const float* l = static_cast<const float*>(lut);
    if (dtype == 0) {
      gn_layernorm_kernel<float><<<rows, kThreads, 0, s>>>(
          static_cast<const float*>(x), g, b, l, static_cast<float*>(y), cols, inv_c,
          subtract_mean, mantissa_bits, iters, inv_sqrt2);
    } else if (dtype == 1) {
      gn_layernorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), g, b, l, static_cast<__nv_bfloat16*>(y),
          cols, inv_c, subtract_mean, mantissa_bits, iters, inv_sqrt2);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
