// Shared device helpers of the GN kernels.
//
// Port of repro/kernels/common.py (factorized_exp, snap_up_to_grid) and of
// the CoRN reciprocal square root in repro/kernels/gn_layernorm/kernel.py
// (_newton_rsqrt_block).  On the TPU a ROM lookup was a one-hot x table
// matmul (common.py:41, the MXU idiom for a missing cheap gather); here it is
// a direct index into the table the host passes in, staged in shared memory
// where a kernel reads it often.
//
// Rounding follows jnp.round: rintf (round half to even), never roundf.
// The kernels are built with -fmad=false, so a*b+c is never contracted into
// an FMA and every product and sum rounds where the reference rounds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gn {

constexpr float NEG_INF = -1e30f;

// Element types the kernels take; the wrappers pass 0 for f32, 1 for bf16.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The two-LUT exponential unit (SoftmaxLUTConfig), passed by value.
struct ExpLut {
  float step;            // Δ units per grid step
  float inv_step;        // 1 / step, rounded to f32 on the host
  int max_delta_int;     // saturation index
  int coarse_shift;      // 3 + frac_bits: coarse index = Δ_int >> coarse_shift
  int residual_mask;     // residual_entries - 1
  int coarse_entries;
  int residual_entries;
  float value_scale;     // 2^lut_value_bits
  float inv_value_scale; // 2^-lut_value_bits, exact
};

// e^{-delta} (delta >= 0) on the fixed-point Δ grid: coarse[Δ >> shift] *
// residual[Δ & mask], rounded to the LUT's fixed-point grid.  Δ past the
// coarse LUT's reach saturates to exactly 0 (common.py:57-77); the saturation
// test happens in float, so a masked score's huge Δ never reaches an int.
// The reference divides the rounded product by 2^bits; multiplying by the
// exact 2^-bits gives the same bits without a division.
__device__ __forceinline__ float factorized_exp(float delta, const float* coarse,
                                                const float* residual, const ExpLut& p) {
  const float r = rintf(delta * p.inv_step);
  if (r > (float)p.max_delta_int) return 0.0f;
  const int d = r > 0.0f ? (int)r : 0;
  const float y = coarse[d >> p.coarse_shift] * residual[d & p.residual_mask];
  return rintf(y * p.value_scale) * p.inv_value_scale;
}

// Ceil a running max onto the Δ grid (common.py:80).
__device__ __forceinline__ float snap_up_to_grid(float m, float step) {
  return ceilf(m / step) * step;
}

// CoRN rsqrt of n > 0: exponent-field LOD, a mantissa LUT, x INV_SQRT2 on odd
// exponents, then `iters` mul-only Newton steps x <- x (1.5 - 0.5 n x^2)
// (gn_layernorm/kernel.py:26-40).
__device__ __forceinline__ float corn_rsqrt(float n, const float* lut, int mantissa_bits,
                                            int iters, float inv_sqrt2) {
  const int bits = __float_as_int(n);
  const int e = ((bits >> 23) & 0xFF) - 127;
  const int idx = (bits >> (23 - mantissa_bits)) & ((1 << mantissa_bits) - 1);
  const int e_half = e >> 1;  // arithmetic shift == floor, also for e < 0
  const float pow2 = __int_as_float((127 - e_half) << 23);
  float x = lut[idx] * pow2 * ((e & 1) ? inv_sqrt2 : 1.0f);
  for (int i = 0; i < iters; ++i) x = x * (1.5f - 0.5f * n * x * x);
  return x;
}

}  // namespace gn
