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

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gn {

constexpr float NEG_INF = -1e30f;

// Element types the kernels take; the wrappers pass 0 for f32, 1 for bf16,
// 2 for int8 (a quantized KV arena, exact in f32).
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) { return static_cast<float>(v); }

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

// The LUT value of grid index d (0 <= d <= max_delta_int): coarse[d >> shift]
// * residual[d & mask], rounded to the LUT's fixed-point grid.  The
// reference divides the rounded product by 2^bits; multiplying by the exact
// 2^-bits gives the same bits without a division.
__device__ __forceinline__ float exp_entry(int d, const float* coarse, const float* residual,
                                           const ExpLut& p) {
  const float y = coarse[d >> p.coarse_shift] * residual[d & p.residual_mask];
  return rintf(y * p.value_scale) * p.inv_value_scale;
}

// e^{-delta} (delta >= 0) on the fixed-point Δ grid.  Δ past the coarse
// LUT's reach saturates to exactly 0 (common.py:57-77); the saturation test
// happens in float, so a masked score's huge Δ never reaches an int.
__device__ __forceinline__ float factorized_exp(float delta, const float* coarse,
                                                const float* residual, const ExpLut& p) {
  const float r = rintf(delta * p.inv_step);
  if (r > (float)p.max_delta_int) return 0.0f;
  const int d = r > 0.0f ? (int)r : 0;
  return exp_entry(d, coarse, residual, p);
}

// The same function read from a product table: table[d] = exp_entry(d) for
// d <= max_delta_int and table[max_delta_int + 1] = 0, so table[exp_index(
// delta)] == factorized_exp(delta) bit for bit for every delta >= 0.
__device__ __forceinline__ int exp_index(float delta, const ExpLut& p) {
  return (int)fminf(rintf(delta * p.inv_step), (float)(p.max_delta_int + 1));
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

// ------------------------------------------- tensor-core helpers (bf16) --
// Shared by the tensor-core designs of gn_attention.cu and
// gn_paged_attention.cu: 16-byte cp.async with its commit/wait pair,
// ldmatrix, mma.sync m16n8k16 bf16 -> f32, the exact hi + lo bf16 split of
// two LUT numerators, and the reductions over the 4 lanes of a quad.
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !in (src is then
// not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Two numerators (columns 2 tig and 2 tig + 1 of a row) as the exact sums
// hi + lo of two bf16 each, packed as A-fragment registers.
__device__ __forceinline__ void split(float y0, float y1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(y0, y1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(y0 - hf.x, y1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Eight head-dim columns [d0, d0 + 8) of one row into shared memory, zeros
// past D or for a row that does not exist: one 16-byte cp.async where the
// rows are aligned (`vec`), else element by element.
__device__ __forceinline__ void load8(bf16* dst, const bf16* row, const bf16* base, int d0, int D,
                                      bool in, bool vec) {
  if (vec) {
    const bool ok = in && d0 < D;  // D % 8 == 0: a chunk is wholly in or out
    cp_async16(dst, ok ? row + d0 : base, ok);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    dst[j] = in && d0 + j < D ? row[d0 + j] : __float2bfloat16_rn(0.0f);
}

}  // namespace gn
