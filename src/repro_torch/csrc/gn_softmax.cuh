// Row-wise GN softmax (the paper's Algorithm 1) for Hopper, with the score
// chain around it fused in.
//
// Replaces the Pallas TPU kernel repro/kernels/gn_softmax/kernel.py
// (_gn_softmax_kernel, gn_softmax_pallas) and its wrapper ops.py:27.  Per
// row: the max snapped up to the Δ grid, Δ = max - x rounded half to even
// onto the grid, the coarse x residual LUT product rounded to Q1.15 (exactly
// 0 past the coarse table's reach), their sum, and one reciprocal per row:
// p = y * (1 / Σy).  Numerators and denominator share the same LUT'd y, so
// Σp = 1 up to the reciprocal's rounding.
//
// Two entries share one kernel:
//  - gn_softmax_launch: x (rows, cols) contiguous -> p in x's dtype (the MoE
//    router's rows, the flash backward's recompute);
//  - gn_softmax_scores_launch: the raw score product (up to 5 dims, any
//    leading strides, its own dtype) -> p in an output dtype, with the chain
//    the model ran around the softmax folded in: s = x * scale rounded to
//    x's dtype (the scale pre-rounded to it), s as f32, -1e30 where a bool
//    mask (read through its broadcast strides, nothing materialised) is
//    false, the softmax, and p rounded to nearest even into the output
//    dtype.  One pass: x read once, p written once, where the chain moved
//    ~32 bytes an element through five launches.
//
// Bound: bytes.  A row is read once and written once, with a dozen integer
// and float operations an element.  So each row stays in registers between
// its passes, in a layout sized to the row from its width alone:
//  - a row is cut into chunks of K = 4 columns (16 bytes of f32, 8 of
//    bf16), held by a group of G threads, CPT chunks a thread: chunk
//    t + G * c on thread t, so that neighbouring threads read neighbouring
//    bytes, one vector access a chunk.  The chunks lie on the output's
//    4-element grid: row r's chunks start s = (r * cols) mod 4 columns
//    before it, so that a row that starts off a 16-byte boundary (any width
//    not a multiple of 4: the VLM's 1601) still moves by whole-chunk
//    accesses between a partial head and a partial tail chunk.  CPT =
//    ceil(chunks / G) over cols + the largest s of the width: no thread
//    carries more than the head and the tail as partly empty chunks;
//  - up to 32 chunks (128 columns): G = the chunks rounded up to a power of
//    two (1 to 32 threads; the router's 16 columns take 4), several rows a
//    warp, reduced with shuffles inside their lane group;
//  - wider rows, up to 8192 columns: a warp, or 2, 4 or 8 warps a row, the
//    fewest that keep CPT within kCpt (3), or 8 warps and up to 8 chunks a
//    thread: 1024 columns take 128 x 2, 1056 and 1500 take 128 x 3, 1601
//    and 2048 take 256 x 2, 4112 takes 256 x 5.  Fewer chunks a thread
//    keeps more rows in flight an SM; wider groups pay two block
//    reductions a row;
//  - every block is 256 threads, 256 / G rows at a time, in a grid-stride
//    loop over row groups on a grid of the blocks that fit on the card at
//    once: the exp table is built in shared memory once a block, while the
//    block's first row group is being loaded;
//  - every load of a row group is issued before any of it is used; whole
//    chunks move by 16-, 8- or 4-byte accesses, the widest that the
//    pointers and the strides' offsets from the output's grid allow (else
//    element by element).  Which thread holds a column depends on the row
//    index and the width alone, never on the dtype, the strides or the
//    access width, so the sums run in one order: the fused entry on bf16
//    scores equals the chain over this kernel on their f32 cast bit for
//    bit.
// The exponential is one lookup in a table of gn::exp_entry over the Δ grid
// (build_table), bitwise gn::factorized_exp.  Wider rows (a vocab-wide row
// of 92544 columns) take one block of 1024 threads per row that loops over
// device memory three times (max, sum, write); they are not on the serving
// path.  Nothing is padded.
//
// One translation unit an element type (gn_softmax.cu: f32 scores,
// gn_softmax_bf16.cu: bf16), each its own library with these C entries for
// its type alone, so that nvcc builds the two in parallel; the wrapper
// loads the library of the scores' dtype.
//
// Left for later: folding the sentinels' Σp probe into this pass, a row kept
// in shared memory between 8192 and ~50K columns, and a cp.async prefetch of
// the next row group.
#pragma once

#include <math.h>

#include "common.cuh"

#ifndef GN_SOFTMAX_T
#error "define GN_SOFTMAX_T (float or __nv_bfloat16) before including gn_softmax.cuh"
#endif

namespace {

using Elem = GN_SOFTMAX_T;
constexpr int kElemCode = sizeof(Elem) == 4 ? 0 : 1;  // the wrappers' dtype code

constexpr int K = 4;                // columns a chunk: 16 bytes of f32, 8 of bf16
constexpr int kThreads = 256;       // threads a block, register layouts
constexpr int kCpt = 3;             // chunks a thread, up to 256 threads a row
constexpr int kMaxCols = 8192;      // widest register row: 256 threads x 8 chunks
constexpr int kRowThreads = 1024;   // wide rows: one block per row, three passes

// The leading dims of the scores (row-major order of the output's rows,
// merged where both x and the mask allow), the strides, in elements, of x
// and of the mask along them, and each size's 32-bit division by
// multiplication: q = (umulhi(n, mul) + n) >> shr for n < 2^31.
struct RowMap {
  int nd;  // 1..4
  uint32_t size[4], mul[4];
  int shr[4];
  long long xs[4], ms[4];
};

struct Args {
  const void* x;
  const uint8_t* mask;  // nullptr: no mask
  void* out;            // (rows, cols) contiguous
  const float* coarse;
  const float* residual;
  long long rows;
  int cols;
  long long xcs, mcs;   // column strides of x and the mask
  int xalign, malign, oalign;  // bytes an access may take (16, 8, 4), 0: element-wise
  int out_bf16;
  int has_scale;
  float scale;          // already rounded to x's dtype
  RowMap map;
  gn::ExpLut lut;
};

// Row `row`'s offsets into x and the mask; ND1: one leading dim.
template <bool ND1>
__device__ __forceinline__ void row_offsets(const RowMap& m, long long row, long long& xo,
                                            long long& mo) {
  if constexpr (ND1) {
    xo = row * m.xs[0], mo = row * m.ms[0];
  } else {
    uint32_t r = static_cast<uint32_t>(row);
    xo = 0, mo = 0;
    for (int d = m.nd - 1; d > 0; --d) {
      const uint32_t q = (__umulhi(r, m.mul[d]) + r) >> m.shr[d];
      const uint32_t i = r - q * m.size[d];
      xo += i * m.xs[d], mo += i * m.ms[d];
      r = q;
    }
    xo += r * m.xs[0], mo += r * m.ms[0];
  }
}

// x's value as the chain held it: x * scale rounded to x's dtype, as f32.
template <typename T>
__device__ __forceinline__ float scaled(float v, const Args& a) {
  if (!a.has_scale) return v;
  return gn::to_float(gn::from_float<T>(v * a.scale));
}

// A thread's chunks of one row as they came from memory: the raw words of
// x (K elements a chunk, 0 past the row's end) and the mask's K bytes.
template <typename T, int CPT>
struct Fetched {
  static constexpr int W = K * sizeof(T) / 4;  // words a chunk
  uint32_t w[CPT][W];
  uint32_t m[CPT];
};

// How far row `row`'s chunks start before its first column: the row's
// offset in the (rows, cols) output, mod K.
__device__ __forceinline__ int row_shift(long long row, int cols) {
  return (static_cast<int>(row & (K - 1)) * (cols & (K - 1))) & (K - 1);
}

// Whether the chunk of columns [c0, c0 + K) lies wholly in a row of `cols`.
__device__ __forceinline__ bool whole(int c0, int cols) { return c0 >= 0 && c0 + K <= cols; }

// Chunk words from p (column c0 of the row): by the widest access the
// alignment allows (at most the chunk's bytes) when the chunk lies wholly
// in the row, else element by element, 0 outside it (also when x's columns
// are strided).
template <typename T>
__device__ __forceinline__ void load_words(const T* p, int c0, int cols, const Args& a,
                                           uint32_t (&w)[K * sizeof(T) / 4]) {
  constexpr int W = K * sizeof(T) / 4;
  const int acc = a.xalign < 4 * W ? a.xalign : 4 * W;
  const bool in = whole(c0, cols);
  if (in && acc >= 16) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = u.x, w[4 * i + 1] = u.y, w[4 * i + 2] = u.z, w[4 * i + 3] = u.w;
    }
  } else if (in && acc == 8) {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p) + i);
      w[2 * i] = u.x, w[2 * i + 1] = u.y;
    }
  } else if (in && acc == 4) {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = __ldg(reinterpret_cast<const uint32_t*>(p) + i);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (c0 + j >= 0 && c0 + j < cols) {
        if constexpr (sizeof(T) == 4) {
          w[j] = __float_as_uint(__ldg(p + j * a.xcs));
        } else {  // bf16: element 2i is the low half of word i
          const uint32_t b = __bfloat16_as_ushort(p[j * a.xcs]);
          w[j >> 1] |= b << (16 * (j & 1));
        }
      }
    }
  }
}

// A chunk's K mask bytes from p (column c0 of the row), byte j for column
// c0 + j, 0 outside the row.
__device__ __forceinline__ uint32_t load_mask(const uint8_t* p, int c0, int cols, const Args& a) {
  if (a.malign && whole(c0, cols)) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (c0 + j >= 0 && c0 + j < cols && p[j * a.mcs]) bits |= 1u << (8 * j);
  return bits;
}

// Issue every load of a thread's chunks of `row` (nothing waits on them).
template <typename T, int G, int CPT, bool ND1>
__device__ __forceinline__ void fetch(const Args& a, long long row, int t, Fetched<T, CPT>& f) {
  long long xo, mo;
  row_offsets<ND1>(a.map, row, xo, mo);
  const T* xr = static_cast<const T*>(a.x) + xo;
  const uint8_t* mr = a.mask + mo;
  const int s = row_shift(row, a.cols);
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int c0 = (t + G * c) * K - s;
    load_words<T>(xr + (long long)c0 * a.xcs, c0, a.cols, a, f.w[c]);
    if (a.mask) f.m[c] = load_mask(mr + (long long)c0 * a.mcs, c0, a.cols, a);
  }
}

// Element j of a chunk's words as f32.
template <typename T>
__device__ __forceinline__ float element(const uint32_t* w, int j) {
  if constexpr (sizeof(T) == 4) return __uint_as_float(w[j]);
  return __uint_as_float(j & 1 ? w[j >> 1] & 0xffff0000u : w[j >> 1] << 16);
}

// K floats rounded to the output dtype, written from p on by the widest
// access `align` allows (at most the chunk's bytes).
template <typename O>
__device__ __forceinline__ void store_chunk(O* p, int align, const float (&v)[K]) {
  constexpr int W = K * sizeof(O) / 4;
  uint32_t w[W];
  if constexpr (sizeof(O) == 4) {
#pragma unroll
    for (int j = 0; j < K; ++j) w[j] = __float_as_uint(v[j]);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i)
      w[i] = gn::pack(__float2bfloat16_rn(v[2 * i]), __float2bfloat16_rn(v[2 * i + 1]));
  }
  const int acc = align < 4 * W ? align : 4 * W;
  if (acc >= 16) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i)
      reinterpret_cast<uint4*>(p)[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  } else if (acc == 8) {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) reinterpret_cast<uint2*>(p)[i] = make_uint2(w[2 * i], w[2 * i + 1]);
  } else if (acc == 4) {
#pragma unroll
    for (int i = 0; i < W; ++i) reinterpret_cast<uint32_t*>(p)[i] = w[i];
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) p[j] = gn::from_float<O>(v[j]);
  }
}

// A chunk of probabilities into the output row at column c0: by
// store_chunk when the chunk lies wholly in the row, else element by
// element.
template <typename O>
__device__ __forceinline__ void write_chunk(O* p, int c0, int cols, int align, const float (&v)[K]) {
  if (whole(c0, cols)) {
    store_chunk(p, align, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (c0 + j >= 0 && c0 + j < cols) p[j] = gn::from_float<O>(v[j]);
}

// Max or sum of one float over each group of G threads (G consecutive
// threads of the block), in a fixed order; every thread of the group gets
// it.  Groups wider than a warp combine their warps' values through `red`
// (kThreads / 32 floats), first warp first.
template <int G, bool kMax>
__device__ __forceinline__ float group_reduce(float v, float* red) {
  constexpr int W = G < 32 ? G : 32;
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, u) : v + u;
  }
  if constexpr (G > 32) {
    constexpr int NW = G / 32;
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    const int first = warp & ~(NW - 1);
    v = red[first];
#pragma unroll
    for (int i = 1; i < NW; ++i) v = kMax ? fmaxf(v, red[first + i]) : v + red[first + i];
    __syncthreads();  // red is reused by the next call
  }
  return v;
}

// The exp ROM's values on the Δ grid, one a grid index, in shared memory:
// table[d] = gn::exp_entry(d) (the coarse x residual product rounded to the
// LUT's grid, read from the two ROMs in device memory) for d <=
// max_delta_int and 0 past it, so that table[gn::exp_index(Δ)] is
// gn::factorized_exp(Δ) bit for bit for every Δ >= 0: one lookup an
// element, no branch.  The register layouts form the same index as
// min(round-half-even(Δ / step) as int, max_delta_int + 1) in one
// conversion (F2I.RN saturates past 2^31, where both give the cap).
__device__ __forceinline__ void build_table(float* table, const Args& a) {
  for (int d = threadIdx.x; d <= a.lut.max_delta_int + 1; d += blockDim.x)
    table[d] = d <= a.lut.max_delta_int ? gn::exp_entry(d, a.coarse, a.residual, a.lut) : 0.0f;
}

// The register layouts: G threads a row, CPT chunks a thread, kThreads / G
// rows a block at a time, row groups in a grid-stride loop; the first row
// group's loads go out before the table is built.  The arguments stay in
// parameter space (__grid_constant__).
// Up to kCpt chunks a thread the registers are held to 5 blocks an SM (40
// warps), past it to 3.  The loop is compiled apart for one leading dim
// (every plain call, and fused scores whose leading dims merge) and for
// several.
template <typename T, int G, int CPT, bool ND1>
__device__ __forceinline__ void rows_loop(const Args& a, float* red, float* table) {
  constexpr int R = kThreads / G;
  const int sub = threadIdx.x / G, t = threadIdx.x % G;
  const int cols = a.cols;
  const long long groups = (a.rows + R - 1) / R;
  // the first row group's loads go out before the table is built
  Fetched<T, CPT> f{};
  if (blockIdx.x * (long long)R + sub < a.rows) fetch<T, G, CPT, ND1>(a, blockIdx.x * (long long)R + sub, t, f);
  build_table(table, a);
  __syncthreads();
  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long row = grp * R + sub;
    const bool live = row < a.rows;
    if (grp != blockIdx.x && live) fetch<T, G, CPT, ND1>(a, row, t, f);
    // the chain's values: x, then x * scale rounded to x's dtype, then
    // -1e30 where masked (uniform branches: the plain entry skips both)
    float v[CPT][K];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int j = 0; j < K; ++j) v[c][j] = element<T>(f.w[c], j);
    if (a.has_scale) {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
#pragma unroll
        for (int j = 0; j < K; ++j) v[c][j] = scaled<T>(v[c][j], a);
    }
    if (a.mask) {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
#pragma unroll
        for (int j = 0; j < K; ++j)
          if (!((f.m[c] >> (8 * j)) & 0xff)) v[c][j] = gn::NEG_INF;
    }
    // chunk c holds columns [c0, c0 + K): wholly in the row, partly (the
    // row's head or tail chunk), or outside it
    const int s = row_shift(row, cols);
    float m = -INFINITY;
    if (live) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int c0 = (t + G * c) * K - s;
        if (whole(c0, cols)) {
#pragma unroll
          for (int j = 0; j < K; ++j) m = fmaxf(m, v[c][j]);
        } else {
#pragma unroll
          for (int j = 0; j < K; ++j)
            if (c0 + j >= 0 && c0 + j < cols) m = fmaxf(m, v[c][j]);
        }
      }
    }
    m = gn::snap_up_to_grid(group_reduce<G, true>(m, red), a.lut.step);
    // Δ = m - x on the grid, one table lookup an element; a sum a chunk,
    // then the chunks in order
    const int top = a.lut.max_delta_int + 1;
    float z = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int c0 = (t + G * c) * K - s;
      float zc = 0.0f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int d = min(__float2int_rn(fmaxf(m - v[c][j], 0.0f) * a.lut.inv_step), top);
        v[c][j] = table[d];
      }
      if (!whole(c0, cols)) {
#pragma unroll
        for (int j = 0; j < K; ++j)
          if (c0 + j < 0 || c0 + j >= cols) v[c][j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < K; ++j) zc += v[c][j];
      z += zc;
    }
    const float inv = 1.0f / group_reduce<G, false>(z, red);
    if (!live) continue;
    const long long o = row * cols;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int c0 = (t + G * c) * K - s;
      if (c0 >= cols || c0 + K <= 0) continue;
#pragma unroll
      for (int j = 0; j < K; ++j) v[c][j] *= inv;
      if (a.out_bf16)
        write_chunk(static_cast<__nv_bfloat16*>(a.out) + o + c0, c0, cols, a.oalign, v[c]);
      else
        write_chunk(static_cast<float*>(a.out) + o + c0, c0, cols, a.oalign, v[c]);
    }
  }
}

template <typename T, int G, int CPT>
__global__ void __launch_bounds__(kThreads, CPT <= kCpt ? 5 : 3)
    gn_softmax_rows_kernel(const __grid_constant__ Args a) {
  __shared__ float red[kThreads / 32];
  extern __shared__ float table[];
  if (a.map.nd == 1)
    rows_loop<T, G, CPT, true>(a, red, table);
  else
    rows_loop<T, G, CPT, false>(a, red, table);
}

// Reduce one float over the block (max or sum); every thread gets it.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  v = group_reduce<32, kMax>(v, red);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) total = kMax ? fmaxf(total, red[i]) : total + red[i];
  __syncthreads();  // red is reused by the next call
  return total;
}

// One block per wide row, three passes over device memory.
template <typename T>
__global__ void __launch_bounds__(kRowThreads) gn_softmax_wide_kernel(const __grid_constant__ Args a) {
  __shared__ float red[kRowThreads / 32];
  extern __shared__ float table[];
  build_table(table, a);
  long long xo, mo;
  row_offsets<false>(a.map, blockIdx.x, xo, mo);
  const T* xr = static_cast<const T*>(a.x) + xo;
  const uint8_t* mr = a.mask + mo;
  auto value = [&](int c) {
    const float s = scaled<T>(gn::to_float(xr[c * a.xcs]), a);
    return a.mask && !mr[c * a.mcs] ? gn::NEG_INF : s;
  };
  float m = -INFINITY;
  for (int c = threadIdx.x; c < a.cols; c += kRowThreads) m = fmaxf(m, value(c));
  // the reduction's syncs cover the table
  m = gn::snap_up_to_grid(block_reduce<true>(m, red), a.lut.step);
  float z = 0.0f;
  for (int c = threadIdx.x; c < a.cols; c += kRowThreads)
    z += table[gn::exp_index(fmaxf(m - value(c), 0.0f), a.lut)];
  const float inv = 1.0f / block_reduce<false>(z, red);
  const long long o = (long long)blockIdx.x * a.cols;
  for (int c = threadIdx.x; c < a.cols; c += kRowThreads) {
    const float p = table[gn::exp_index(fmaxf(m - value(c), 0.0f), a.lut)] * inv;
    if (a.out_bf16)
      static_cast<__nv_bfloat16*>(a.out)[o + c] = __float2bfloat16_rn(p);
    else
      static_cast<float*>(a.out)[o + c] = p;
  }
}

// The SM count and each instance's occupancy are cached per device ordinal,
// from the device current at the launch (the launch helper makes the tensors'
// card current), so the shards of a sharded engine or the ranks of a sharded
// step on cards of two models each size their grids to their own card.
constexpr int kMaxDevices = 64;

int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev < 0 || dev >= kMaxDevices ? 0 : dev;
}

int num_sms(int dev) {
  static int sms[kMaxDevices] = {};
  if (!sms[dev]) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

template <typename T, int G, int CPT>
cudaError_t launch_rows(const Args& a, size_t smem, cudaStream_t s) {
  static int per_sm[kMaxDevices] = {};  // blocks of this instance resident on one SM
  const int dev = current_device();
  if (!per_sm[dev]) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gn_softmax_rows_kernel<T, G, CPT>,
                                                  kThreads, smem);
    per_sm[dev] = n < 1 ? 1 : n;
  }
  const long long groups = (a.rows + kThreads / G - 1) / (kThreads / G);
  const long long cap = (long long)per_sm[dev] * num_sms(dev);
  gn_softmax_rows_kernel<T, G, CPT><<<(unsigned)(groups < cap ? groups : cap), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// The instances, pick's layouts: G 1..32 at CPT 1; 32, 64 and 128 at CPT 2
// and 3; 256 at 2..8.
template <typename T, int G>
cudaError_t launch_g(const Args& a, int cpt, size_t smem, cudaStream_t s) {
  if constexpr (G < 32) {
    return cpt == 1 ? launch_rows<T, G, 1>(a, smem, s) : cudaErrorInvalidValue;
  } else {
    switch (cpt) {
      case 1: if constexpr (G == 32) return launch_rows<T, G, 1>(a, smem, s); break;
      case 2: return launch_rows<T, G, 2>(a, smem, s);
      case 3: return launch_rows<T, G, 3>(a, smem, s);
      case 4: if constexpr (G == 256) return launch_rows<T, G, 4>(a, smem, s); break;
      case 5: if constexpr (G == 256) return launch_rows<T, G, 5>(a, smem, s); break;
      case 6: if constexpr (G == 256) return launch_rows<T, G, 6>(a, smem, s); break;
      case 7: if constexpr (G == 256) return launch_rows<T, G, 7>(a, smem, s); break;
      case 8: if constexpr (G == 256) return launch_rows<T, G, 8>(a, smem, s); break;
    }
    return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(const Args& a, int g, int cpt, cudaStream_t s) {
  const size_t smem = (size_t)(a.lut.max_delta_int + 2) * sizeof(float);  // the table
  switch (g) {
    case 0:
      gn_softmax_wide_kernel<T><<<(unsigned)a.rows, kRowThreads, smem, s>>>(a);
      return cudaGetLastError();
    case 1: return launch_g<T, 1>(a, cpt, smem, s);
    case 2: return launch_g<T, 2>(a, cpt, smem, s);
    case 4: return launch_g<T, 4>(a, cpt, smem, s);
    case 8: return launch_g<T, 8>(a, cpt, smem, s);
    case 16: return launch_g<T, 16>(a, cpt, smem, s);
    case 32: return launch_g<T, 32>(a, cpt, smem, s);
    case 64: return launch_g<T, 64>(a, cpt, smem, s);
    case 128: return launch_g<T, 128>(a, cpt, smem, s);
    case 256: return launch_g<T, 256>(a, cpt, smem, s);
  }
  return cudaErrorInvalidValue;
}

// The layout for rows of `cols` columns: G threads a row (0: the wide
// kernel) and CPT, enough for cols + the largest head shift of the width
// (row_shift: 0 when cols is a multiple of K, 2 when it is 2 mod K, else 3).
void pick(int cols, int& g, int& cpt) {
  const int shift = cols % K == 0 ? 0 : cols % K == 2 ? 2 : K - 1;
  const int chunks = (cols + shift + K - 1) / K;
  if (cols + shift > kMaxCols) {
    g = 0, cpt = 0;
    return;
  }
  if (chunks <= 32) {
    g = 1;
    while (g < chunks) g <<= 1;
    cpt = 1;
    return;
  }
  for (g = 32; g < 256; g <<= 1)
    if ((chunks + g - 1) / g <= kCpt) break;
  cpt = (chunks + g - 1) / g;
}

// The leading dims (sizes, x and mask strides), size-1 dims dropped and a
// dim merged into the one before it where both x and the mask step over
// it evenly; each size's divisor for row_offsets.
bool make_map(RowMap& m, int nd, const long long* sizes, const long long* xs,
              const long long* ms) {
  m.nd = 0;
  for (int d = 0; d < nd; ++d) {
    if (sizes[d] == 1) continue;
    if (sizes[d] < 1 || sizes[d] > 0x7fffffffLL) return false;
    const int k = m.nd - 1;
    if (k >= 0 && m.xs[k] == sizes[d] * xs[d] && m.ms[k] == sizes[d] * ms[d]) {
      m.size[k] = (uint32_t)(m.size[k] * sizes[d]), m.xs[k] = xs[d], m.ms[k] = ms[d];
    } else {
      m.size[k + 1] = (uint32_t)sizes[d], m.xs[k + 1] = xs[d], m.ms[k + 1] = ms[d];
      m.nd = k + 2;
    }
  }
  if (m.nd == 0) m.nd = 1, m.size[0] = 1, m.xs[0] = 0, m.ms[0] = 0;
  for (int d = 0; d < m.nd; ++d) {  // shr = ceil(log2 size), mul = 2^32 (2^shr - size) / size + 1
    int shr = 0;
    while ((1ull << shr) < m.size[d]) ++shr;
    m.shr[d] = shr;
    m.mul[d] = (uint32_t)(((1ull << 32) * ((1ull << shr) - m.size[d])) / m.size[d] + 1);
  }
  return true;
}

// The lowest set bit of v, at most 16: the widest access v's alignment allows.
int align_of(unsigned long long v) {
  int a = 16;
  while (a > 1 && (v & (unsigned long long)(a - 1))) a >>= 1;
  return a >= 4 ? a : 0;
}

// Checks the arguments, picks the layout and launches.
int run(Args& a, int dtype, void* stream) {
  if (a.rows == 0) return static_cast<int>(cudaGetLastError());
  if (a.rows < 0 || a.cols < 1 || a.rows > 0x7fffffffLL || a.map.nd < 1 || a.map.nd > 4 ||
      dtype != kElemCode)
    return static_cast<int>(cudaErrorInvalidValue);
  int g, cpt;
  pick(a.cols, g, cpt);
  return static_cast<int>(launch<Elem>(a, g, cpt, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// The layout the entries pick for rows of `cols` columns: *g threads a row
// (0: the three-pass wide kernel), *cpt chunks of K columns a thread.
extern "C" int gn_softmax_layout(int cols, int* g, int* cpt) {
  pick(cols, *g, *cpt);
  return 0;
}

// x, out: (rows, cols) contiguous, f32 (dtype 0) or bf16 (dtype 1; each
// library takes its own type and refuses the other), out in x's dtype;
// coarse, residual: the f32 exp ROM tables.  rows < 2^31, cols >= 1.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int gn_softmax_launch(const void* x, const void* coarse, const void* residual,
                                 void* out, long long rows, int cols, int dtype, float step,
                                 float inv_step, int max_delta_int, int coarse_shift,
                                 int residual_mask, int coarse_entries, int residual_entries,
                                 float value_scale, void* stream) {
  Args a{};
  a.x = x, a.mask = nullptr, a.out = out;
  a.coarse = static_cast<const float*>(coarse), a.residual = static_cast<const float*>(residual);
  a.rows = rows, a.cols = cols, a.xcs = 1, a.mcs = 0;
  // x's rows lie where the output's do: each is as aligned as its pointer
  a.xalign = align_of(reinterpret_cast<uintptr_t>(x));
  a.oalign = align_of(reinterpret_cast<uintptr_t>(out));
  a.malign = 0, a.out_bf16 = dtype == 1, a.has_scale = 0, a.scale = 1.0f;
  const long long xs = cols, ms = 0;
  make_map(a.map, 1, &rows, &xs, &ms);
  a.lut = gn::ExpLut{step, inv_step, max_delta_int, coarse_shift, residual_mask,
                     coarse_entries, residual_entries, value_scale, 1.0f / value_scale};
  return run(a, dtype, stream);
}

// The fused entry.  x: the raw scores, f32 (dtype 0) or bf16 (dtype 1),
// `nd` <= 4 leading dims of sizes `sizes` and element strides `xs`, then
// `cols` columns at stride `xcs`; mask: bool bytes or nullptr, strides `ms`
// and `mcs` over the same dims (0 along a broadcast dim); scale applied
// when has_scale (already rounded to x's dtype); out: (rows, cols)
// contiguous, bf16 when out_bf16, else f32.
extern "C" int gn_softmax_scores_launch(const void* x, const void* mask, void* out,
                                        const void* coarse, const void* residual, int nd,
                                        const long long* sizes, const long long* xs,
                                        const long long* ms, int cols, long long xcs,
                                        long long mcs, int dtype, int out_bf16, int has_scale,
                                        float scale, float step, float inv_step,
                                        int max_delta_int, int coarse_shift, int residual_mask,
                                        int coarse_entries, int residual_entries,
                                        float value_scale, void* stream) {
  if (nd < 1 || nd > 4) return static_cast<int>(cudaErrorInvalidValue);
  const int esize = dtype == 1 ? 2 : 4;
  Args a{};
  a.x = x, a.mask = static_cast<const uint8_t*>(mask), a.out = out;
  a.coarse = static_cast<const float*>(coarse), a.residual = static_cast<const float*>(residual);
  long long mstr[4] = {0, 0, 0, 0};
  a.rows = 1;
  for (int d = 0; d < nd; ++d) a.rows *= sizes[d], mstr[d] = mask ? ms[d] : 0;
  if (a.rows > 0x7fffffffLL || !make_map(a.map, nd, sizes, xs, mstr))
    return static_cast<int>(cudaErrorInvalidValue);
  // a row's chunks lie on the output's grid (row_shift): x's and the
  // mask's rows are as aligned as their pointers and their strides' offsets
  // from the output's, whose stride along dim d is os
  unsigned long long xbits = reinterpret_cast<uintptr_t>(x);
  unsigned long long mbits = reinterpret_cast<uintptr_t>(mask);
  long long os = cols;
  for (int d = a.map.nd - 1; d >= 0; --d) {
    if (a.map.size[d] > 1)
      xbits |= (unsigned long long)((a.map.xs[d] - os) * esize),
          mbits |= (unsigned long long)(a.map.ms[d] - os);
    os *= a.map.size[d];
  }
  a.cols = cols, a.xcs = xcs, a.mcs = mask ? mcs : 0;
  a.xalign = xcs == 1 ? align_of(xbits) : 0;
  a.malign = mask && mcs == 1 && (mbits & 3) == 0;
  a.oalign = align_of(reinterpret_cast<uintptr_t>(out));
  a.out_bf16 = out_bf16, a.has_scale = has_scale, a.scale = scale;
  a.lut = gn::ExpLut{step, inv_step, max_delta_int, coarse_shift, residual_mask,
                     coarse_entries, residual_entries, value_scale, 1.0f / value_scale};
  return run(a, dtype, stream);
}
