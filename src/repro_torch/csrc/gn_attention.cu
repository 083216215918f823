// Contiguous GN flash attention for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/gn_attention/kernel.py
// (_gn_attention_kernel, gn_attention_pallas) and its wrapper ops.py:23.
// q (B, H, Sq, D), k and v (B, Hkv, Sk, D), q head h reads kv head h / G,
// G = H / Hkv.  Query row i attends the columns c < Sk, and with `causal`
// only c <= i + (Sk - Sq), the KV-prefix offset.  The online (m, l, acc)
// update follows the Pallas kernel step by step (kernel.py:69-124): q scaled
// in f32 before an f32 dot, the running max snapped up to the Δ grid, a row
// that has seen nothing keeps m = NEG_INF, the correction
// factorized_exp(clip(m_new - m_old, 0, step * (max_delta_int + 1))) (0 with
// no history), masked numerators exactly 0, and acc / l at the end (l <= 0
// divides by 1).  Only the order of the f32 sums differs; the dots
// accumulate with an explicit fused multiply-add.
//
// Layout and grid: one block per (q tile, kv head, batch) serves all G q
// heads of its kv head, 64 rows in all (G heads x 64 / G positions), so
// each K/V tile is loaded from device memory once, not G times.  The walk
// over key tiles (the TPU's sequential grid axis) is a loop inside the
// block; with `causal` it stops at the last tile the tile's rows can see,
// so tiles wholly above the diagonal are never loaded, and the longest
// walks are scheduled first.  The ragged Sq and Sk edges are masked here;
// nothing is padded per call.  256 threads as 16 x 16: thread (ty, tx)
// owns rows ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and head-dim
// columns tx + 16 dc, so a score costs half a shared-memory load per
// multiply-add and the row max and sum reduce over a half warp.  Any head
// dim up to 256 is taken (DC = head-dim columns per thread, a power of two).
//
// Bound: operations at the forward's shape (4 * B * H * D * visible pairs
// against 989 TFLOP/s bf16 on the tensor cores), bytes only for short
// sequences.  This first version does its dots on the CUDA cores in f32 and
// overlaps no load with math, so it sits far above the tensor-core bound;
// wgmma dots, TMA loads into a ring of stages and a causal split of the
// longest walks are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;             // query rows per block (G heads x BQ positions)
constexpr int kKeys = 64;             // keys per tile
constexpr int kYLd = kKeys + 16;      // numerator row stride: the half warps hit other banks

__device__ __forceinline__ float half_warp_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
gn_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ coarse_g, const float* __restrict__ residual_g,
                    T* __restrict__ out, int H, int Hkv, int Sq, int Sk, int D, int BQ,
                    int causal, float sm_scale, gn::ExpLut lut) {
  const int G = H / Hkv, R = G * BQ, ld = D + 1, offset = Sk - Sq;
  const int tile = gridDim.x - 1 - blockIdx.x;  // the longest causal walks first
  const int kvh = blockIdx.y, b = blockIdx.z, i0 = tile * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  extern __shared__ float smem[];
  float* q_s = smem;                    // kRows x ld   scaled f32 queries
  float* k_s = q_s + kRows * ld;        // kKeys x ld   this tile's keys
  float* v_s = k_s + kKeys * ld;        // kKeys x D    this tile's values
  float* y_s = v_s + kKeys * D;         // kRows x kYLd this tile's numerators
  float* coarse = y_s + kRows * kYLd;   // the two exp ROM tables
  float* residual = coarse + lut.coarse_entries;

  for (int i = tid; i < lut.coarse_entries; i += kThreads) coarse[i] = coarse_g[i];
  for (int i = tid; i < lut.residual_entries; i += kThreads) residual[i] = residual_g[i];
  // row r = g * BQ + i: q head kvh * G + g at position i0 + i (kernel.py:70)
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D, pos = i0 + r % BQ;
    float val = 0.0f;
    if (r < R && pos < Sq)
      val = gn::to_float(q[(((size_t)b * H + kvh * G + r / BQ) * Sq + pos) * D + d]) * sm_scale;
    q_s[r * ld + d] = val;
  }

  // this thread's rows: their position, whether they exist, and the last
  // column each may see (causal: pos + offset; always < Sk)
  int pos[4], lim[4];
  bool rv[4];
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    pos[i] = i0 + r % BQ;
    rv[i] = r < R && pos[i] < Sq;
    lim[i] = causal ? min(Sk - 1, pos[i] + offset) : Sk - 1;
    m[i] = gn::NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) acc[i][dc] = 0.0f;
  }
  // key tiles up to the last column any row of this tile may see
  int last = Sk - 1;
  if (causal) last = min(last, min(i0 + BQ, Sq) - 1 + offset);
  const int n_tiles = last < 0 ? 0 : last / kKeys + 1;
  const float max_corr = lut.step * (float)(lut.max_delta_int + 1);

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int c0 = jt * kKeys, keys = min(kKeys, Sk - c0);
    __syncthreads();  // the previous tile's products are done with k_s, v_s, y_s
    for (int idx = tid; idx < kKeys * D; idx += kThreads) {
      const int t = idx / D, d = idx - t * D;
      const bool in = t < keys;
      const size_t off = (((size_t)b * Hkv + kvh) * Sk + c0 + t) * D + d;
      k_s[t * ld + d] = in ? gn::to_float(k[off]) : 0.0f;
      v_s[t * D + d] = in ? gn::to_float(v[off]) : 0.0f;
    }
    __syncthreads();

    // scores: a 4 x 4 tile per thread, one f32 dot each (kernel.py:73-75)
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    const float* qrow = q_s + ty * ld;
    const float* krow = k_s + tx * ld;
    for (int d = 0; d < D; ++d) {
      float a[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qrow[16 * i * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = krow[16 * j * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(a[i], kb[j], s[i][j]);
    }

    // online update of each row (kernel.py:77-111); the 16 threads of a row
    // are one half warp and hold identical copies of its m and l
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float m_cur = gn::NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        if (!(rv[i] && col <= lim[i])) s[i][j] = gn::NEG_INF;
        m_cur = fmaxf(m_cur, s[i][j]);
      }
      m_cur = half_warp_max(m_cur);
      // both mask bounds are upper bounds on the column, so a row sees some
      // column of this tile iff it sees the first one
      const bool any_valid = rv[i] && c0 <= lim[i];
      const bool started = m[i] > gn::NEG_INF / 2;
      float m_new = gn::snap_up_to_grid(fmaxf(m[i], m_cur), lut.step);
      if (!(any_valid || started)) m_new = m[i];
      const float corr =
          started ? gn::factorized_exp(fminf(fmaxf(m_new - m[i], 0.0f), max_corr), coarse,
                                       residual, lut)
                  : 0.0f;
      const bool live = m_new > gn::NEG_INF / 2;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        float y = 0.0f;
        if (live && rv[i] && col <= lim[i])
          y = gn::factorized_exp(fmaxf(m_new - s[i][j], 0.0f), coarse, residual, lut);
        y_s[r * kYLd + tx + 16 * j] = y;
        sum += y;
      }
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) acc[i][dc] *= corr;
    }
    __syncthreads();

    // acc += y @ v over the tile's keys (kernel.py:107-109)
    for (int c = 0; c < keys; ++c) {
      float yv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) yv[i] = y_s[(ty + 16 * i) * kYLd + c];
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const int d = tx + 16 * dc;
        vv[dc] = d < D ? v_s[c * D + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int dc = 0; dc < DC; ++dc) acc[i][dc] = __fmaf_rn(yv[i], vv[dc], acc[i][dc]);
    }
  }

  // guaranteed normalization: the LUT'd numerators over their own sum; a
  // row that saw nothing (l == 0) divides by 1 and stays 0 (kernel.py:119-124)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!rv[i]) continue;
    const int h = kvh * G + (ty + 16 * i) / BQ;
    const float inv = 1.0f / (l[i] > 0.0f ? l[i] : 1.0f);
    T* orow = out + (((size_t)b * H + h) * Sq + pos[i]) * D;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      const int d = tx + 16 * dc;
      if (d < D) orow[d] = gn::from_float<T>(acc[i][dc] * inv);
    }
  }
}

template <typename T, int DC>
int launch(const void* q, const void* k, const void* v, const float* coarse,
           const float* residual, void* out, int B, int H, int Hkv, int Sq, int Sk, int D,
           int causal, float sm_scale, const gn::ExpLut& lut, cudaStream_t stream) {
  const int BQ = kRows / (H / Hkv);
  const size_t floats = (size_t)(kRows + kKeys) * (D + 1) + (size_t)kKeys * D +
                        (size_t)kRows * kYLd + lut.coarse_entries + lut.residual_entries;
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gn_attention_kernel<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, Hkv, B);
  gn_attention_kernel<T, DC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), coarse,
      residual, static_cast<T*>(out), H, Hkv, Sq, Sk, D, BQ, causal, sm_scale, lut);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const float* coarse,
             const float* residual, void* out, int B, int H, int Hkv, int Sq, int Sk, int D,
             int causal, float sm_scale, const gn::ExpLut& lut, cudaStream_t stream) {
  // DC: the smallest power of two with 16 * DC >= D
  if (D <= 16)
    return launch<T, 1>(q, k, v, coarse, residual, out, B, H, Hkv, Sq, Sk, D, causal, sm_scale,
                        lut, stream);
  if (D <= 32)
    return launch<T, 2>(q, k, v, coarse, residual, out, B, H, Hkv, Sq, Sk, D, causal, sm_scale,
                        lut, stream);
  if (D <= 64)
    return launch<T, 4>(q, k, v, coarse, residual, out, B, H, Hkv, Sq, Sk, D, causal, sm_scale,
                        lut, stream);
  if (D <= 128)
    return launch<T, 8>(q, k, v, coarse, residual, out, B, H, Hkv, Sq, Sk, D, causal, sm_scale,
                        lut, stream);
  return launch<T, 16>(q, k, v, coarse, residual, out, B, H, Hkv, Sq, Sk, D, causal, sm_scale,
                       lut, stream);
}

}  // namespace

// q, out: (B, H, Sq, D) contiguous; k, v: (B, Hkv, Sk, D) contiguous, all of
// one dtype, f32 (dtype 0) or bf16 (dtype 1); 1 <= D <= 256; H a multiple of
// Hkv with G = H / Hkv <= 64; coarse, residual: the f32 exp ROM tables.
// Launches on `stream` and returns cudaGetLastError() (or the error of the
// shared-memory opt-in).
extern "C" int gn_attention_launch(const void* q, const void* k, const void* v,
                                   const void* coarse, const void* residual, void* out, int B,
                                   int H, int Hkv, int Sq, int Sk, int D, int causal, int dtype,
                                   float sm_scale, float step, float inv_step, int max_delta_int,
                                   int coarse_shift, int residual_mask, int coarse_entries,
                                   int residual_entries, float value_scale, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  if (B < 0 || Sq < 0 || Sk < 0 || D < 1 || D > 256 || Hkv < 1 || H % Hkv || H / Hkv > kRows ||
      B > 65535 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const gn::ExpLut lut{step, inv_step, max_delta_int, coarse_shift, residual_mask,
                       coarse_entries, residual_entries, value_scale, 1.0f / value_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* co = static_cast<const float*>(coarse);
  const float* re = static_cast<const float*>(residual);
  if (dtype == 0)
    return dispatch<float>(q, k, v, co, re, out, B, H, Hkv, Sq, Sk, D, causal, sm_scale, lut, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, co, re, out, B, H, Hkv, Sq, Sk, D, causal, sm_scale,
                                   lut, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
