// GN LayerNorm / RMSNorm (CoRN-LN) for Hopper, and the residual add fused in.
//
// Replaces the Pallas TPU kernel repro/kernels/gn_layernorm/kernel.py
// (_gn_layernorm_kernel, gn_layernorm_pallas).  Per row: the mean square
// (RMS) or the centred variance (the mean first, then the squares of the
// centred values), accumulated in f32 and taken as sum * (1/C) like the
// Pallas kernel; then the CoRN rsqrt of var + 1e-8; then x rstd gamma
// (+ beta), rounded once to the output type.  The model runs it 2L+1 times a
// pass (ln1 and ln2 of every layer, the final norm) on (rows, d_model)
// activations.
//
// The fused entry (gn_add_layernorm_launch) first forms s = x + r as
// PyTorch's eager add does (the sum in f32, rounded once to x's type), writes
// s once and normalises it from registers.  s equals x + r and y equals the
// unfused kernel's output on s bit for bit, in the same layout: both run the
// same code on the same values in the same order.  The model fuses every
// norm that follows a residual add (2L-1 a pass), which saves the add's
// launch and its pass through device memory.
//
// Bound: bytes.  A row is a few KB and needs a handful of flops a byte, so
// the design reads each row from device memory once, holds it in registers
// as 16-byte chunks (8 bf16 or 4 f32 a load and a store) between the
// reductions and the write, and loads gamma and beta as float4.  The
// elements before and after a row's 16-byte aligned body (the scalar edge)
// take one register each on the first threads.  A row belongs to a group of
// G threads, each holding CPT chunks; the C entry picks G from rows, cols
// and the pointers' alignment:
//  - warp (G = 32): one warp per row, eight rows a block, reductions by
//    shuffles only;
//  - block (G = 64, 128 or 256): one block per row, reductions through
//    shared memory;
//  - stream (rows past 256 x 8 chunks, or x, y, r and s that do not share
//    their offset mod 16): one block of 256 threads per row that loops over
//    device memory, one pass per reduction and one for the write.
// Few rows (under kFewRows: a tick's 128, a decode step's 8) spread each row
// over up to 256 threads, one chunk a thread, so that a row's latency is one
// load; many rows (prefill, the forward) give each thread two chunks, which
// keeps more bytes in flight with fewer threads to synchronise.  So a warp
// takes rows of up to 32 chunks when rows are few and up to 64 when they
// are many (bf16: 256 and 512 columns).  Measured on an NVIDIA H100 80GB
// HBM3 at 700 W (kernel_ab.py --norm-layouts, each layout forced): at 8448 x
// 2048 bf16, RMS / LayerNorm / fused RMS took 26.6 / 27.7 / 47.8 us with two
// chunks a thread, 27.2 / 32.4 / 48.3 with one, 25.8 / 28.4 / 48.9 with four
// and 26.8 / 32.5 / 50.5 with eight (a warp), against 24.6 us for a plain
// copy of the norm's bytes; at 128 rows one chunk a thread took 2.2 us, a
// warp 4.4.  Every reduction runs in a fixed order (per-chunk partial sums
// added in chunk order, then the edge, then the group), so a layout's
// result is deterministic.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;             // the widest group, and the stream layout's block
constexpr int kWarpRows = kThreads / 32;  // warp layout: rows (one warp each) a block
constexpr int kMaxCpt = 8;                // at most G x 8 chunks a row in registers
// Below this many rows each row is spread one chunk a thread; on the H100
// one chunk a thread wins at 528 rows of 2048 bf16 (2.7 against 2.9 us),
// two win at 1056 (3.5 against 4.0).
constexpr long long kFewRows = 132 * kWarpRows;
constexpr int kStream = 0;  // layout code; a group layout's code is its G

struct Args {
  const void* x;
  const void* r;  // fused entry only, else null
  void* s;        // fused entry only, else null
  const float* gamma;
  const float* beta;  // may be null
  const float* lut;
  void* y;
  long long rows;
  int cols;
  float inv_c;
  int subtract_mean;
  int mantissa_bits;
  int iters;
  float inv_sqrt2;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of one float per thread over a block of NT threads, in a fixed order;
// every thread gets the total.  `red` holds NT / 32 + 1 floats.
template <int NT>
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (NT >> 5) ? red[lane] : 0.0f;
    t = warp_sum(t);
    if (lane == 0) red[NT >> 5] = t;
  }
  __syncthreads();
  const float total = red[NT >> 5];
  __syncthreads();  // red is reused by the next call
  return total;
}

// A 16-byte chunk of T held as raw bits, and its values as floats.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[16 / sizeof(T)]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i in the low half, 2i + 1 in the high
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&v)[16 / sizeof(T)]) {
  uint32_t w[4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// x + r as the eager add computes it: in f32, rounded once to T
template <typename T>
__device__ __forceinline__ uint4 add_chunk(const uint4& x, const uint4& r) {
  constexpr int VEC = 16 / sizeof(T);
  float a[VEC], b[VEC];
  unpack<T>(x, a);
  unpack<T>(r, b);
#pragma unroll
  for (int j = 0; j < VEC; ++j) a[j] = a[j] + b[j];
  return pack<T>(a);
}

template <typename T>
__device__ __forceinline__ float add_one(T x, T r) {
  return gn::to_float(gn::from_float<T>(gn::to_float(x) + gn::to_float(r)));
}

// N consecutive f32 parameters from column `col`: float4 loads where `vec`
template <int N>
__device__ __forceinline__ void load_params(const float* p, int col, float (&out)[N], bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + col + i));
      out[i] = t.x, out[i + 1] = t.y, out[i + 2] = t.z, out[i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __ldg(p + col + i);
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One row held in registers by a group of G threads (a warp, or the block):
// thread t holds chunks t + G c (c < CPT) of the row's aligned body and, for
// t < n_edge, one element of the scalar edge.  `sum` reduces one float per
// thread over the group, in a fixed order.
template <typename T, int CPT, int G, bool ADD, typename Sum>
__device__ __forceinline__ void norm_row(const Args& a, long long row, int t, Sum sum) {
  constexpr int VEC = 16 / sizeof(T);
  const long long off = row * a.cols;
  const T* xr = static_cast<const T*>(a.x) + off;
  const T* rr = ADD ? static_cast<const T*>(a.r) + off : nullptr;
  T* sr = ADD ? static_cast<T*>(a.s) + off : nullptr;
  T* yr = static_cast<T*>(a.y) + off;
  const int cols = a.cols;
  // the aligned body [head, tail0) in nvec chunks; the edge is [0, head) and
  // [tail0, cols), n_edge elements (x, r, s and y share their offset mod 16)
  const int head =
      min(cols, (int)(((16 - (reinterpret_cast<uintptr_t>(xr) & 15)) & 15) / sizeof(T)));
  const int nvec = (cols - head) / VEC, tail0 = head + nvec * VEC;
  const int n_edge = head + cols - tail0;
  const int edge = t < head ? t : tail0 + t - head;

  uint4 raw[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int ch = t + G * c;
    if (ch < nvec) raw[c] = *reinterpret_cast<const uint4*>(xr + head + ch * VEC);
  }
  if constexpr (ADD) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int ch = t + G * c;
      if (ch < nvec) {
        raw[c] = add_chunk<T>(raw[c], *reinterpret_cast<const uint4*>(rr + head + ch * VEC));
        *reinterpret_cast<uint4*>(sr + head + ch * VEC) = raw[c];
      }
    }
  }
  float e = 0.0f;
  if (t < n_edge) {
    if constexpr (ADD) {
      e = add_one(xr[edge], rr[edge]);
      sr[edge] = gn::from_float<T>(e);
    } else {
      e = gn::to_float(xr[edge]);
    }
  }

  // stage (i): moments in f32, divided by the true C
  // a thread's sums: one partial a chunk (independent chains), added in
  // chunk order, then the edge element
  float mu = 0.0f;
  if (a.subtract_mean) {
    float part[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      part[c] = 0.0f;
      if (t + G * c < nvec) {
        float v[VEC];
        unpack<T>(raw[c], v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) part[c] += v[j];
      }
    }
    float acc = part[0];
#pragma unroll
    for (int c = 1; c < CPT; ++c) acc += part[c];
    if (t < n_edge) acc += e;
    mu = sum(acc) * a.inv_c;
  }
  float part[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    part[c] = 0.0f;
    if (t + G * c < nvec) {
      float v[VEC];
      unpack<T>(raw[c], v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = v[j] - mu;
        part[c] += d * d;
      }
    }
  }
  float acc = part[0];
#pragma unroll
  for (int c = 1; c < CPT; ++c) acc += part[c];
  if (t < n_edge) {
    const float d = e - mu;
    acc += d * d;
  }
  const float var = sum(acc) * a.inv_c;

  // stage (ii): CoRN rsqrt, then the multiply-only output stage
  const float rstd = gn::corn_rsqrt(var + 1e-8f, a.lut, a.mantissa_bits, a.iters, a.inv_sqrt2);
  const bool has_beta = a.beta != nullptr;
  const bool vec = aligned16(a.gamma + head) && (!has_beta || aligned16(a.beta + head));
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int ch = t + G * c;
    if (ch < nvec) {
      const int col = head + ch * VEC;
      float v[VEC], g[VEC];
      unpack<T>(raw[c], v);
      load_params(a.gamma, col, g, vec);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = (v[j] - mu) * rstd * g[j];
      if (has_beta) {
        load_params(a.beta, col, g, vec);
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[j] = v[j] + g[j];
      }
      *reinterpret_cast<uint4*>(yr + col) = pack<T>(v);
    }
  }
  if (t < n_edge) {
    float v = (e - mu) * rstd * __ldg(a.gamma + edge);
    if (has_beta) v = v + __ldg(a.beta + edge);
    yr[edge] = gn::from_float<T>(v);
  }
}

template <typename T, int CPT, bool ADD>
__global__ void __launch_bounds__(kThreads) norm_warp_kernel(Args a) {
  const long long row = (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= a.rows) return;
  norm_row<T, CPT, 32, ADD>(a, row, threadIdx.x & 31, [](float v) { return warp_sum(v); });
}

template <typename T, int CPT, int G, bool ADD>
__global__ void __launch_bounds__(G) norm_block_kernel(Args a) {
  __shared__ float red[G / 32 + 1];
  norm_row<T, CPT, G, ADD>(a, blockIdx.x, threadIdx.x,
                           [&](float v) { return block_sum<G>(v, red); });
}

// One block per row, one pass over device memory per reduction and one for
// the write; the fused mode forms s = x + r anew in each pass (the same
// value each time) and writes it in the last.
template <typename T, bool ADD>
__global__ void __launch_bounds__(kThreads) norm_stream_kernel(Args a) {
  __shared__ float red[kThreads / 32 + 1];
  const long long off = (long long)blockIdx.x * a.cols;
  const T* xr = static_cast<const T*>(a.x) + off;
  const T* rr = ADD ? static_cast<const T*>(a.r) + off : nullptr;
  T* yr = static_cast<T*>(a.y) + off;
  auto val = [&](int i) {
    if constexpr (ADD) return add_one(xr[i], rr[i]);
    return gn::to_float(xr[i]);
  };
  float mu = 0.0f;
  if (a.subtract_mean) {
    float acc = 0.0f;
    for (int i = threadIdx.x; i < a.cols; i += kThreads) acc += val(i);
    mu = block_sum<kThreads>(acc, red) * a.inv_c;
  }
  float acc = 0.0f;
  for (int i = threadIdx.x; i < a.cols; i += kThreads) {
    const float d = val(i) - mu;
    acc += d * d;
  }
  const float var = block_sum<kThreads>(acc, red) * a.inv_c;
  const float rstd = gn::corn_rsqrt(var + 1e-8f, a.lut, a.mantissa_bits, a.iters, a.inv_sqrt2);
  for (int i = threadIdx.x; i < a.cols; i += kThreads) {
    const float v = val(i);
    if constexpr (ADD) static_cast<T*>(a.s)[off + i] = gn::from_float<T>(v);
    float o = (v - mu) * rstd * a.gamma[i];
    if (a.beta != nullptr) o = o + a.beta[i];
    yr[i] = gn::from_float<T>(o);
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// Chunks a thread of a G-thread group: the smallest power of two whose G x
// CPT chunks cover the row (>= its aligned body).
int chunks_per_thread(int cols, int vec, int g) {
  return pow2_at_least((((cols + vec - 1) / vec) + g - 1) / g);
}

// The group size G (the layout code), or kStream.
int pick(long long rows, int cols, int vec, bool aligned) {
  const int chunks = (cols + vec - 1) / vec;
  const int per_thread = rows < kFewRows ? 1 : 2;
  const int g = min(kThreads, max(32, pow2_at_least((chunks + per_thread - 1) / per_thread)));
  return aligned && chunks_per_thread(cols, vec, g) <= kMaxCpt ? g : kStream;
}

template <typename T, bool ADD, int CPT>
cudaError_t launch_cpt(const Args& a, int g, cudaStream_t s) {
  const unsigned rows = (unsigned)a.rows;
  switch (g) {
    case 32:
      norm_warp_kernel<T, CPT, ADD><<<(rows + kWarpRows - 1) / kWarpRows, kThreads, 0, s>>>(a);
      break;
    case 64: norm_block_kernel<T, CPT, 64, ADD><<<rows, 64, 0, s>>>(a); break;
    case 128: norm_block_kernel<T, CPT, 128, ADD><<<rows, 128, 0, s>>>(a); break;
    case 256: norm_block_kernel<T, CPT, 256, ADD><<<rows, 256, 0, s>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, bool ADD>
cudaError_t launch(const Args& a, int layout, cudaStream_t s) {
  if (layout == kStream) {
    norm_stream_kernel<T, ADD><<<(unsigned)a.rows, kThreads, 0, s>>>(a);
    return cudaGetLastError();
  }
  switch (chunks_per_thread(a.cols, 16 / sizeof(T), layout)) {
    case 1: return launch_cpt<T, ADD, 1>(a, layout, s);
    case 2: return launch_cpt<T, ADD, 2>(a, layout, s);
    case 4: return launch_cpt<T, ADD, 4>(a, layout, s);
    case 8: return launch_cpt<T, ADD, 8>(a, layout, s);
    default: return cudaErrorInvalidValue;
  }
}

int vec_of(int dtype) { return dtype == 0 ? 4 : 8; }

bool same_offset(const void* a, const void* b) {
  return b == nullptr ||
         (reinterpret_cast<uintptr_t>(a) & 15) == (reinterpret_cast<uintptr_t>(b) & 15);
}

// Checks the arguments and the layout (-1: pick one), then launches.
int run(const Args& a, int dtype, int layout, cudaStream_t s) {
  if (a.rows == 0) return static_cast<int>(cudaGetLastError());
  if (a.rows < 0 || a.rows > 0x7fffffffLL || a.cols < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = vec_of(dtype);
  const bool aligned = same_offset(a.x, a.y) && same_offset(a.x, a.r) && same_offset(a.x, a.s);
  if (layout < 0) layout = pick(a.rows, a.cols, vec, aligned);
  const bool group = layout == 32 || layout == 64 || layout == 128 || layout == 256;
  if (layout != kStream &&
      !(group && aligned && chunks_per_thread(a.cols, vec, layout) <= kMaxCpt))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool add = a.r != nullptr;
  cudaError_t err;
  if (dtype == 0)
    err = add ? launch<float, true>(a, layout, s) : launch<float, false>(a, layout, s);
  else
    err = add ? launch<__nv_bfloat16, true>(a, layout, s)
              : launch<__nv_bfloat16, false>(a, layout, s);
  return static_cast<int>(err);
}

}  // namespace

// x, y: (rows, cols) contiguous, f32 (dtype 0) or bf16 (dtype 1); gamma, beta:
// (cols,) f32, beta may be null; lut: the (1 << mantissa_bits,) f32 CoRN table.
// layout: a group size (32: warp; 64, 128, 256: block), 0 stream, or -1 for
// the entry's pick (a forced layout the row does not fit is refused).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int gn_layernorm_launch(const void* x, const void* gamma, const void* beta,
                                   const void* lut, void* y, long long rows, int cols,
                                   float inv_c, int dtype, int subtract_mean,
                                   int mantissa_bits, int iters, float inv_sqrt2, int layout,
                                   void* stream) {
  const Args a{x, nullptr, nullptr, static_cast<const float*>(gamma),
               static_cast<const float*>(beta), static_cast<const float*>(lut), y, rows, cols,
               inv_c, subtract_mean, mantissa_bits, iters, inv_sqrt2};
  return run(a, dtype, layout, static_cast<cudaStream_t>(stream));
}

// The fused entry: r like x, s like y; writes s = x + r (rounded once to the
// dtype) and y = the norm of s.
extern "C" int gn_add_layernorm_launch(const void* x, const void* r, void* s, const void* gamma,
                                       const void* beta, const void* lut, void* y,
                                       long long rows, int cols, float inv_c, int dtype,
                                       int subtract_mean, int mantissa_bits, int iters,
                                       float inv_sqrt2, int layout, void* stream) {
  if (r == nullptr || s == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, r, s, static_cast<const float*>(gamma), static_cast<const float*>(beta),
               static_cast<const float*>(lut), y, rows, cols, inv_c, subtract_mean,
               mantissa_bits, iters, inv_sqrt2};
  return run(a, dtype, layout, static_cast<cudaStream_t>(stream));
}

// The layout code the entries pick for rows x cols of dtype when every
// pointer shares its offset mod 16 (`aligned`), else stream.
extern "C" int gn_layernorm_layout(long long rows, int cols, int dtype, int aligned) {
  return pick(rows, cols, vec_of(dtype), aligned != 0);
}
