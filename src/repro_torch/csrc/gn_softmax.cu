// Row-wise GN softmax (the paper's Algorithm 1) for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/gn_softmax/kernel.py
// (_gn_softmax_kernel, gn_softmax_pallas) and its wrapper ops.py:27.  Per
// row: the max snapped up to the Δ grid, Δ = max - x rounded half to even
// onto the grid, the coarse x residual LUT product rounded to Q1.15 (exactly
// 0 past the coarse table's reach), their sum, and one reciprocal per row:
// p = y * (1 / Σy).  Numerators and denominator share the same LUT'd y, so
// Σp = 1 up to the reciprocal's rounding.  The serving path runs it on the
// one-pass score rows of prefill ((B·H·S, S) f32) and of every decode step
// ((B·H, max_seq) f32).
//
// Bound: bytes.  A row is read once and written once, with a few dozen
// integer and float operations per element.  So the design keeps each row
// on chip between its passes: one warp per row, the row in registers (up to
// 2048 columns, VPT values a lane), max and sum reduced with shuffles, eight
// rows per block.  Nothing is padded: lanes past the row's end hold -inf and
// write nothing.  Wider rows (a vocab-wide row of 92544 columns) take one
// block of 1024 threads per row that loops over device memory three times
// (max, sum, write); they are not on the serving path.
//
// Left for later: 16-byte vector loads, a row kept in shared memory between
// 2048 and ~50K columns, and fusing the mask and the f32 cast of the scores
// into this kernel.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarpRows = 8;         // rows (one warp each) per block, register path
constexpr int kMaxVpt = 64;          // register path: cols <= 32 * kMaxVpt
constexpr int kRowThreads = 1024;    // wide rows: one block per row

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy the two exp ROM tables into shared memory.
__device__ __forceinline__ void stage_luts(float* coarse, float* residual, const float* coarse_g,
                                           const float* residual_g, const gn::ExpLut& lut) {
  for (int i = threadIdx.x; i < lut.coarse_entries; i += blockDim.x) coarse[i] = coarse_g[i];
  for (int i = threadIdx.x; i < lut.residual_entries; i += blockDim.x) residual[i] = residual_g[i];
}

// One warp per row; the row lives in registers, VPT values per lane.
template <typename T, int VPT>
__global__ void __launch_bounds__(32 * kWarpRows)
gn_softmax_warp_kernel(const T* __restrict__ x, const float* __restrict__ coarse_g,
                       const float* __restrict__ residual_g, T* __restrict__ out, long long rows,
                       int cols, gn::ExpLut lut) {
  extern __shared__ float smem[];
  float* coarse = smem;
  float* residual = coarse + lut.coarse_entries;
  stage_luts(coarse, residual, coarse_g, residual_g, lut);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * cols;
  T* outr = out + row * cols;

  float v[VPT];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < cols ? gn::to_float(xr[c]) : -INFINITY;
    m = fmaxf(m, v[i]);
  }
  m = gn::snap_up_to_grid(warp_max(m), lut.step);
  float z = 0.0f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < cols ? gn::factorized_exp(fmaxf(m - v[i], 0.0f), coarse, residual, lut) : 0.0f;
    z += v[i];
  }
  const float inv = 1.0f / warp_sum(z);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    if (c < cols) outr[c] = gn::from_float<T>(v[i] * inv);
  }
}

// Reduce one float per thread over the block (max or sum); every thread gets
// the result.  `red` holds kRowThreads / 32 + 1 floats.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (kRowThreads >> 5) ? red[lane] : (kMax ? -INFINITY : 0.0f);
    t = kMax ? warp_max(t) : warp_sum(t);
    if (lane == 0) red[kRowThreads >> 5] = t;
  }
  __syncthreads();
  const float total = red[kRowThreads >> 5];
  __syncthreads();  // red is reused by the next call
  return total;
}

// One block per wide row, three passes over device memory.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
gn_softmax_row_kernel(const T* __restrict__ x, const float* __restrict__ coarse_g,
                      const float* __restrict__ residual_g, T* __restrict__ out, int cols,
                      gn::ExpLut lut) {
  __shared__ float red[kRowThreads / 32 + 1];
  extern __shared__ float smem[];
  float* coarse = smem;
  float* residual = coarse + lut.coarse_entries;
  stage_luts(coarse, residual, coarse_g, residual_g, lut);
  const T* xr = x + (long long)blockIdx.x * cols;
  T* outr = out + (long long)blockIdx.x * cols;
  float m = -INFINITY;
  for (int c = threadIdx.x; c < cols; c += kRowThreads) m = fmaxf(m, gn::to_float(xr[c]));
  m = gn::snap_up_to_grid(block_reduce<true>(m, red), lut.step);  // its syncs cover the LUTs
  float z = 0.0f;
  for (int c = threadIdx.x; c < cols; c += kRowThreads)
    z += gn::factorized_exp(fmaxf(m - gn::to_float(xr[c]), 0.0f), coarse, residual, lut);
  const float inv = 1.0f / block_reduce<false>(z, red);
  for (int c = threadIdx.x; c < cols; c += kRowThreads)
    outr[c] = gn::from_float<T>(
        gn::factorized_exp(fmaxf(m - gn::to_float(xr[c]), 0.0f), coarse, residual, lut) * inv);
}

template <typename T, int VPT>
cudaError_t launch_warp(const void* x, const float* coarse, const float* residual, void* out,
                        long long rows, int cols, const gn::ExpLut& lut, size_t smem,
                        cudaStream_t stream) {
  const long long blocks = (rows + kWarpRows - 1) / kWarpRows;
  gn_softmax_warp_kernel<T, VPT><<<(unsigned)blocks, 32 * kWarpRows, smem, stream>>>(
      static_cast<const T*>(x), coarse, residual, static_cast<T*>(out), rows, cols, lut);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* coarse, const float* residual, void* out,
                   long long rows, int cols, const gn::ExpLut& lut, cudaStream_t stream) {
  const size_t smem = (size_t)(lut.coarse_entries + lut.residual_entries) * sizeof(float);
  // the smallest power-of-two VPT whose 32 * VPT lanes cover the row
  if (cols <= 32) return launch_warp<T, 1>(x, coarse, residual, out, rows, cols, lut, smem, stream);
  if (cols <= 64) return launch_warp<T, 2>(x, coarse, residual, out, rows, cols, lut, smem, stream);
  if (cols <= 128) return launch_warp<T, 4>(x, coarse, residual, out, rows, cols, lut, smem, stream);
  if (cols <= 256) return launch_warp<T, 8>(x, coarse, residual, out, rows, cols, lut, smem, stream);
  if (cols <= 512) return launch_warp<T, 16>(x, coarse, residual, out, rows, cols, lut, smem, stream);
  if (cols <= 1024) return launch_warp<T, 32>(x, coarse, residual, out, rows, cols, lut, smem, stream);
  if (cols <= 32 * kMaxVpt)
    return launch_warp<T, kMaxVpt>(x, coarse, residual, out, rows, cols, lut, smem, stream);
  gn_softmax_row_kernel<T><<<(unsigned)rows, kRowThreads, smem, stream>>>(
      static_cast<const T*>(x), coarse, residual, static_cast<T*>(out), cols, lut);
  return cudaGetLastError();
}

}  // namespace

// x, out: (rows, cols) contiguous, f32 (dtype 0) or bf16 (dtype 1); coarse,
// residual: the f32 exp ROM tables.  rows < 2^31 (one grid dimension),
// cols >= 1.  Launches on `stream` and returns cudaGetLastError().
extern "C" int gn_softmax_launch(const void* x, const void* coarse, const void* residual,
                                 void* out, long long rows, int cols, int dtype, float step,
                                 float inv_step, int max_delta_int, int coarse_shift,
                                 int residual_mask, int coarse_entries, int residual_entries,
                                 float value_scale, void* stream) {
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  if (rows < 0 || cols < 1 || rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const gn::ExpLut lut{step, inv_step, max_delta_int, coarse_shift, residual_mask,
                       coarse_entries, residual_entries, value_scale, 1.0f / value_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* co = static_cast<const float*>(coarse);
  const float* re = static_cast<const float*>(residual);
  if (dtype == 0) return static_cast<int>(launch<float>(x, co, re, out, rows, cols, lut, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(x, co, re, out, rows, cols, lut, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
