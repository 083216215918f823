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
// on chip between its passes, in one of two layouts chosen from rows and
// cols:
//  - many rows (the prefill's): one warp per row, the row in registers (up
//    to 2048 columns, VPT values a lane), max and sum reduced with shuffles,
//    eight rows per block.  Lanes past the row's end hold -inf and write
//    nothing.
//  - few rows (a decode step's (B·H, max_seq)), too few for a warp each to
//    fill the card, or rows of 2049..8192 columns: one block of 256 threads
//    per row, the row in registers as 16-byte chunks (CPT a thread), max and
//    sum reduced through shared memory.  The row's 16-byte aligned body
//    moves by vector loads and stores; the few elements before and after it
//    (the scalar edge) take one register each on the first threads.
// Wider rows (a vocab-wide row of 92544 columns) take one block of 1024
// threads per row that loops over device memory three times (max, sum,
// write); they are not on the serving path.  Nothing is padded.
//
// Left for later: a row kept in shared memory between 8192 and ~50K
// columns, and fusing the mask and the f32 cast of the scores into this
// kernel.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarpRows = 8;         // rows (one warp each) per block, warp layout
constexpr int kMaxVpt = 64;          // warp layout: cols <= 32 * kMaxVpt
constexpr int kBlockThreads = 256;   // block layout: one block per row ...
constexpr int kMaxCpt = 8;           // ... of at most 256 * 8 16-byte chunks
// Below this many rows the warp layout fills less than half of the card's
// warp slots (132 SMs x 64 warps): the block layout takes them.
constexpr long long kFewRows = 132 * 64 / 2;
constexpr int kRowThreads = 1024;    // wide rows: one block per row, three passes

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
// the result.  `red` holds kThreads / 32 + 1 floats.
template <bool kMax, int kThreads>
__device__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (kThreads >> 5) ? red[lane] : (kMax ? -INFINITY : 0.0f);
    t = kMax ? warp_max(t) : warp_sum(t);
    if (lane == 0) red[kThreads >> 5] = t;
  }
  __syncthreads();
  const float total = red[kThreads >> 5];
  __syncthreads();  // red is reused by the next call
  return total;
}

// 16 bytes of a row as floats, and back.
__device__ __forceinline__ void load_chunk(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store_chunk(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_chunk(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 t;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = t;
}

// One block per row; the row lives in registers, CPT 16-byte chunks a
// thread (chunk tid + 256 c of the aligned body) plus one scalar-edge
// element on the first threads.  x and out share their offset mod 16.
template <typename T, int CPT>
__global__ void __launch_bounds__(kBlockThreads)
gn_softmax_block_kernel(const T* __restrict__ x, const float* __restrict__ coarse_g,
                        const float* __restrict__ residual_g, T* __restrict__ out, int cols,
                        gn::ExpLut lut) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red[kBlockThreads / 32 + 1];
  extern __shared__ float smem[];
  float* coarse = smem;
  float* residual = coarse + lut.coarse_entries;
  stage_luts(coarse, residual, coarse_g, residual_g, lut);
  const T* xr = x + (long long)blockIdx.x * cols;
  T* outr = out + (long long)blockIdx.x * cols;
  // the aligned body [head, tail0) in nvec chunks; the edge is [0, head)
  // and [tail0, cols), n_edge elements, thread t < n_edge holding one
  const int head =
      min(cols, (int)(((16 - (reinterpret_cast<uintptr_t>(xr) & 15)) & 15) / sizeof(T)));
  const int nvec = (cols - head) / VEC, tail0 = head + nvec * VEC;
  const int n_edge = head + cols - tail0, tid = threadIdx.x;
  const int edge = tid < head ? tid : tail0 + tid - head;

  float v[CPT][VEC];
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int ch = tid + kBlockThreads * c;
    if (ch < nvec) {
      load_chunk(xr + head + ch * VEC, v[c]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) m = fmaxf(m, v[c][j]);
    }
  }
  float e = tid < n_edge ? gn::to_float(xr[edge]) : -INFINITY;
  m = fmaxf(m, e);
  // the reduction's syncs cover the LUTs
  m = gn::snap_up_to_grid(block_reduce<true, kBlockThreads>(m, red), lut.step);
  float z = 0.0f;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    if (tid + kBlockThreads * c < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[c][j] = gn::factorized_exp(fmaxf(m - v[c][j], 0.0f), coarse, residual, lut);
        z += v[c][j];
      }
    }
  }
  if (tid < n_edge) {
    e = gn::factorized_exp(fmaxf(m - e, 0.0f), coarse, residual, lut);
    z += e;
  }
  const float inv = 1.0f / block_reduce<false, kBlockThreads>(z, red);
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int ch = tid + kBlockThreads * c;
    if (ch < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[c][j] *= inv;
      store_chunk(outr + head + ch * VEC, v[c]);
    }
  }
  if (tid < n_edge) outr[edge] = gn::from_float<T>(e * inv);
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
  // the reduction's syncs cover the LUTs
  m = gn::snap_up_to_grid(block_reduce<true, kRowThreads>(m, red), lut.step);
  float z = 0.0f;
  for (int c = threadIdx.x; c < cols; c += kRowThreads)
    z += gn::factorized_exp(fmaxf(m - gn::to_float(xr[c]), 0.0f), coarse, residual, lut);
  const float inv = 1.0f / block_reduce<false, kRowThreads>(z, red);
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

template <typename T, int CPT>
cudaError_t launch_block(const void* x, const float* coarse, const float* residual, void* out,
                         long long rows, int cols, const gn::ExpLut& lut, size_t smem,
                         cudaStream_t stream) {
  gn_softmax_block_kernel<T, CPT><<<(unsigned)rows, kBlockThreads, smem, stream>>>(
      static_cast<const T*>(x), coarse, residual, static_cast<T*>(out), cols, lut);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* coarse, const float* residual, void* out,
                   long long rows, int cols, const gn::ExpLut& lut, cudaStream_t stream) {
  const size_t smem = (size_t)(lut.coarse_entries + lut.residual_entries) * sizeof(float);
  // block layout: few rows, or rows past the warp layout's reach, as long as
  // a row fits the block's registers and x and out share their alignment
  constexpr int VEC = 16 / sizeof(T);
  const long long chunks = (cols + VEC - 1) / VEC;  // >= the aligned body's chunks
  const bool same_align =
      (reinterpret_cast<uintptr_t>(x) & 15) == (reinterpret_cast<uintptr_t>(out) & 15);
  if (same_align && (rows < kFewRows || cols > 32 * kMaxVpt) &&
      chunks <= (long long)kBlockThreads * kMaxCpt) {
    // the smallest power-of-two CPT whose 256 * CPT chunks cover the row
    if (chunks <= kBlockThreads)
      return launch_block<T, 1>(x, coarse, residual, out, rows, cols, lut, smem, stream);
    if (chunks <= 2 * kBlockThreads)
      return launch_block<T, 2>(x, coarse, residual, out, rows, cols, lut, smem, stream);
    if (chunks <= 4 * kBlockThreads)
      return launch_block<T, 4>(x, coarse, residual, out, rows, cols, lut, smem, stream);
    return launch_block<T, kMaxCpt>(x, coarse, residual, out, rows, cols, lut, smem, stream);
  }
  // warp layout: the smallest power-of-two VPT whose 32 * VPT lanes cover the row
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
