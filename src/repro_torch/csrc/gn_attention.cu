// Contiguous GN flash attention for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/gn_attention/kernel.py
// (_gn_attention_kernel, gn_attention_pallas) and its wrapper ops.py:23.
// q (B, H, Sq, D), k and v (B, Hkv, Sk, D), q head h reads kv head h / G,
// G = H / Hkv.  Query row i attends the columns c < Sk, and with `causal`
// only c <= i + (Sk - Sq), the KV-prefix offset.  The online (m, l, acc)
// update follows the Pallas kernel step by step (kernel.py:69-124): the
// running max snapped up to the Δ grid, a row that has seen nothing keeps
// m = NEG_INF, the correction factorized_exp(clip(m_new - m_old, 0, step *
// (max_delta_int + 1))) (0 with no history), masked numerators exactly 0,
// and acc / l at the end (l <= 0 divides by 1).
//
// Two designs share that update and the grid: one block per (q tile, kv
// head, batch) serves all G q heads of its kv head, 64 rows in all (G heads
// x 64 / G positions; row r is head r / BQ at position i0 + r % BQ), so each
// K/V tile is loaded from device memory once, not G times.  The walk over
// key tiles (the TPU's sequential grid axis) is a loop inside the block;
// with `causal` it stops at the last tile the tile's rows can see, so tiles
// wholly above the diagonal are never loaded, and the longest walks are
// scheduled first.  The ragged Sq, Sk and D edges are masked here; nothing
// is padded per call.  Bound: operations at the forward's shape (4 * B * H
// * D * visible pairs against 989 TFLOP/s bf16 on the tensor cores).
//
// bf16 (the model's dtype) runs on the tensor cores (tc:: below).  Four
// warps of 16 rows each; K/V tiles stay bf16 in shared memory, double
// buffered with 16-byte cp.async so tile j+1 loads while tile j computes;
// fragments come in by ldmatrix (.trans for V).  S = q k^T is mma.sync
// m16n8k16 bf16 with f32 accumulation, scaled by sm_scale after the dot as
// both plain versions do (a bf16 x bf16 product is exact in f32, so a score
// differs from the plain version's only in the order and the tensor core's
// rounding of its f32 sum).  The GN update runs on the accumulator fragment
// in registers, a row's max and sum reduced over the 4 lanes of a quad.
// The two exp ROM tables are expanded once per block into their product
// table in shared memory (the same f32 product and rounding as
// factorized_exp, plus the saturated 0), so a score costs one lookup; a tile
// that every row of a warp sees whole skips the mask, and the rescale of acc
// is skipped where no row of the warp moved its max (x * 1 == x).  P V
// takes each LUT numerator y, a Q1.15 value in [0, 1], as the exact sum
// hi + lo of two bf16 (hi = bf16(y), lo = bf16(y - hi); exact for any
// multiple of 2^-b in [0, 1] with b <= 17; a bf16 call with a finer LUT takes
// the CUDA-core design): two mma.sync against the same V fragment.
// acc then sums exactly the numerators l sums, so Σp = 1 holds as in the
// f32 design; rounding p to one bf16 would cost up to 2^-9 per numerator.
// The S fragment is the P fragment's layout, so numerators never leave
// registers.  Tiles of 32 keys keep a block at ~52 KB of shared memory and
// <= 128 registers a thread (D <= 128), so 4 blocks share an SM: measured
// on an H100, 64-key tiles at 2 blocks an SM and q fragments held in
// registers at 3 both ran slower.  The head dim is zero-filled in shared
// memory up to a multiple of 16 (zeros change no dot).  Unaligned rows
// (D % 8 != 0 or a pointer off 16 bytes) load and store element by element.
//
// f32, and bf16 with LUT values of more than 17 bits, run on the CUDA cores
// (the first design, unchanged): the tensor cores have no exact f32 product
// (TF32 keeps 10 of the 23 mantissa bits).  256
// threads as 16 x 16: thread (ty, tx) owns rows ty + 16 i (i < 4), score
// columns tx + 16 j (j < 4) and head-dim columns tx + 16 dc; q is scaled in
// f32 before an f32 dot with an explicit fused multiply-add (kernel.py:70),
// the tiles are widened to f32 in shared memory, and no load overlaps math.
// It is far above the bound and kept for f32 parity runs.
//
// Left for later: wgmma with TMA loads into a ring of stages and a producer
// warp, and a split of the longest causal walks over two blocks.

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

// ------------------------------------------------------- tensor cores (bf16) --
namespace tc {

using gn::bf16;
using gn::cp_async16;
using gn::cp_async_commit;
using gn::cp_async_wait;
using gn::ldsm_x4;
using gn::ldsm_x4_trans;
using gn::load8;
using gn::mma;
using gn::quad_max;
using gn::quad_sum;
using gn::split;

constexpr int kWarps = 4;               // 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 32;               // keys a tile

// Blocks an SM should hold per head-dim instantiation; the register budget
// follows from it (D <= 128: 4 blocks of 128 threads, <= 128 registers).
constexpr int min_blocks(int DP) { return DP <= 128 ? 4 : 2; }

template <int DP>
constexpr size_t smem_bytes(int table_entries) {
  return (size_t)(64 + 4 * kKeys) * (DP + 8) * sizeof(bf16) +
         (size_t)table_entries * sizeof(float);
}

// DP: head dim padded to the instantiation (64, 128, 256).
template <int DP>
__global__ void __launch_bounds__(kThreads, min_blocks(DP))
gn_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ coarse_g,
                       const float* __restrict__ residual_g, bf16* __restrict__ out, int H,
                       int Hkv, int Sq, int Sk, int D, int BQ, int causal, int vec,
                       float sm_scale, gn::ExpLut lut) {
  constexpr int KN = kKeys;
  constexpr int LD = DP + 8;  // row stride: ldmatrix's 8 row addresses hit 8 bank groups
  constexpr int CH = DP / 8;  // 16-byte chunks a row
  constexpr int NT = KN / 8;  // score n-tiles a tile
  const int G = H / Hkv, R = G * BQ, offset = Sk - Sq;
  const int tile = gridDim.x - 1 - blockIdx.x;  // the longest causal walks first
  const int kvh = blockIdx.y, b = blockIdx.z, i0 = tile * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int dk = (D + 15) >> 4;  // 16-wide head-dim steps that hold data
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // 64 x LD, later the output rows
  bf16* k_s = q_s + 64 * LD;                       // 2 stages x KN x LD
  bf16* v_s = k_s + 2 * KN * LD;                   // 2 stages x KN x LD
  float* table = reinterpret_cast<float*>(v_s + 2 * KN * LD);

  // the two ROM tables expanded into their product table, the saturated 0
  // last: one lookup a score instead of two and the product's rounding
  for (int d = tid; d <= lut.max_delta_int + 1; d += kThreads)
    table[d] = d > lut.max_delta_int ? 0.0f : gn::exp_entry(d, coarse_g, residual_g, lut);
  for (int idx = tid; idx < 64 * CH; idx += kThreads) {
    const int r = idx / CH, c = idx - r * CH, pos = i0 + r % BQ;
    const bool in = r < R && pos < Sq;
    const bf16* row = q + (((size_t)b * H + kvh * G + r / BQ) * Sq + (in ? pos : 0)) * D;
    load8(q_s + r * LD + 8 * c, in ? row : q, q, 8 * c, D, in, vec);
  }
  auto load_kv = [&](int jt, int st) {
    const int c0 = jt * KN;
    for (int idx = tid; idx < KN * CH; idx += kThreads) {
      const int t = idx / CH, c = idx - t * CH;
      const bool in = c0 + t < Sk;
      const size_t off = (((size_t)b * Hkv + kvh) * Sk + (in ? c0 + t : 0)) * D;
      load8(k_s + (st * KN + t) * LD + 8 * c, k + off, k, 8 * c, D, in, vec);
      load8(v_s + (st * KN + t) * LD + 8 * c, v + off, v, 8 * c, D, in, vec);
    }
  };

  // this lane's two rows (gid and gid + 8 of the warp's 16): whether they
  // exist and the last column each may see (causal: pos + offset; < Sk)
  int lim[2];
  bool rv[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i, pos = i0 + r % BQ;
    rv[i] = r < R && pos < Sq;
    lim[i] = causal ? min(Sk - 1, pos + offset) : Sk - 1;
    m[i] = gn::NEG_INF;
    l[i] = 0.0f;
  }
  const int lim_min = min(rv[0] ? lim[0] : -1, rv[1] ? lim[1] : -1);
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  int last = Sk - 1;
  if (causal) last = min(last, min(i0 + BQ, Sq) - 1 + offset);
  const int n_tiles = last < 0 ? 0 : last / KN + 1;
  const float max_corr = lut.step * (float)(lut.max_delta_int + 1);

  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();  // q and the first K/V tile
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int st = jt & 1, c0 = jt * KN;
    if (jt + 1 < n_tiles) {
      load_kv(jt + 1, st ^ 1);  // the other stage, free since the end of jt - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = k_s + st * KN * LD;
    const bf16* vs = v_s + st * KN * LD;

    // S = q k^T over the head-dim steps that hold data (kernel.py:73-75)
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < DP / 16; ++kt) {
      if (kt >= dk) break;
      uint32_t a[4];
      ldsm_x4(a, q_s + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kt * 16 +
                     (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kt * 16 +
                        ((lane >> 3) & 1) * 8);
        mma(s[2 * np], a, bk[0], bk[1]);
        mma(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // online update of the lane's two rows (kernel.py:77-111); element e of
    // n-tile n is row gid + 8 (e >> 1), column c0 + 8 n + 2 tig + (e & 1).
    // Masked scores become NEG_INF; a tile that every row of the warp sees
    // whole (all but the diagonal and ragged ones) skips the mask.
    float mx[2] = {gn::NEG_INF, gn::NEG_INF};
    if (__all_sync(0xffffffffu, c0 + KN - 1 <= lim_min)) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] *= sm_scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, col = c0 + 8 * n + 2 * tig + (e & 1);
          s[n][e] = rv[i] && col <= lim[i] ? s[n][e] * sm_scale : gn::NEG_INF;
          mx[i] = fmaxf(mx[i], s[n][e]);
        }
    }
    float corr[2];
    bool live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_cur = quad_max(mx[i]);
      // both mask bounds are upper bounds on the column, so a row sees some
      // column of this tile iff it sees the first one
      const bool any_valid = rv[i] && c0 <= lim[i];
      const bool started = m[i] > gn::NEG_INF / 2;
      float m_new = gn::snap_up_to_grid(fmaxf(m[i], m_cur), lut.step);
      if (!(any_valid || started)) m_new = m[i];
      corr[i] = started
                    ? table[gn::exp_index(fminf(fmaxf(m_new - m[i], 0.0f), max_corr), lut)]
                    : 0.0f;
      live[i] = m_new > gn::NEG_INF / 2;
      m[i] = m_new;
    }
    // numerators: a masked score's Δ (>= 5e29) saturates to exactly 0, and a
    // row that has seen nothing takes none
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float y = table[gn::exp_index(fmaxf(m[i] - s[n][e], 0.0f), lut)];
        s[n][e] = live[i] ? y : 0.0f;
        sum[i] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(sum[i]);
    // x * 1 == x: the rescale runs only where a row of the warp moved its max
    if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    }

    // acc += y v (kernel.py:107-109), y = hi + lo exactly: n-tiles 2 kk and
    // 2 kk + 1 of S are the A fragment of key step kk
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int nd = 0; nd < DP / 16; ++nd) {
        if (nd >= dk) break;
        uint32_t bv[4];
        ldsm_x4_trans(bv, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + nd * 16 +
                              (lane >> 4) * 8);
        mma(acc[2 * nd], ph, bv[0], bv[1]);
        mma(acc[2 * nd], pl, bv[0], bv[1]);
        mma(acc[2 * nd + 1], ph, bv[2], bv[3]);
        mma(acc[2 * nd + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  if (n_tiles == 0) {  // q's copies must land before its rows take the output
    cp_async_wait<0>();
    __syncthreads();
  }

  // guaranteed normalization: the LUT'd numerators over their own sum; a row
  // that saw nothing (l == 0) divides by 1 and stays 0 (kernel.py:119-124).
  // The warp stages its 16 output rows in its own q rows, then stores them.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.0f / (l[i] > 0.0f ? l[i] : 1.0f);
  bf16* o_s = q_s + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat162 pair =
          __floats2bfloat162_rn(acc[n][2 * i] * inv[i], acc[n][2 * i + 1] * inv[i]);
      *reinterpret_cast<__nv_bfloat162*>(o_s + (gid + 8 * i) * LD + 8 * n + 2 * tig) = pair;
    }
  __syncwarp();
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int rr = idx / CH, c = idx - rr * CH, r = warp * 16 + rr, pos = i0 + r % BQ;
    if (r >= R || pos >= Sq || 8 * c >= D) continue;
    bf16* dst = out + (((size_t)b * H + kvh * G + r / BQ) * Sq + pos) * D + 8 * c;
    const bf16* src = o_s + rr * LD + 8 * c;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 8 && 8 * c + j < D; ++j) dst[j] = src[j];
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const float* coarse, const float* residual,
           void* out, int B, int H, int Hkv, int Sq, int Sk, int D, int causal, float sm_scale,
           const gn::ExpLut& lut, cudaStream_t stream) {
  const int BQ = 64 / (H / Hkv);
  const size_t smem = smem_bytes<DP>(lut.max_delta_int + 2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gn_attention_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = D % 8 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(out);
  const dim3 grid((Sq + BQ - 1) / BQ, Hkv, B);
  gn_attention_tc_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      coarse, residual, static_cast<bf16*>(out), H, Hkv, Sq, Sk, D, BQ, causal, vec, sm_scale,
      lut);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, const float* coarse,
             const float* residual, void* out, int B, int H, int Hkv, int Sq, int Sk, int D,
             int causal, float sm_scale, const gn::ExpLut& lut, cudaStream_t stream) {
  if (D <= 64)
    return launch<64>(q, k, v, coarse, residual, out, B, H, Hkv, Sq, Sk, D, causal, sm_scale,
                      lut, stream);
  if (D <= 128)
    return launch<128>(q, k, v, coarse, residual, out, B, H, Hkv, Sq, Sk, D, causal, sm_scale,
                       lut, stream);
  return launch<256>(q, k, v, coarse, residual, out, B, H, Hkv, Sq, Sk, D, causal, sm_scale, lut,
                     stream);
}

}  // namespace tc

}  // namespace

// q, out: (B, H, Sq, D) contiguous; k, v: (B, Hkv, Sk, D) contiguous, all of
// one dtype, f32 (dtype 0) or bf16 (dtype 1); 1 <= D <= 256; H a multiple of
// Hkv with G = H / Hkv <= 64; coarse, residual: the f32 exp ROM tables.  The
// caller names the design (ops.py `design`): tensor_core 1 runs the
// tensor-core design, which takes bf16 with LUT values of at most 17 bits
// (value_scale <= 2^17, the exact hi + lo split) and refuses anything else;
// tensor_core 0 runs the CUDA-core design in either dtype.  Launches on
// `stream` and returns cudaGetLastError() (or the error of the shared-memory
// opt-in).
extern "C" int gn_attention_launch(const void* q, const void* k, const void* v,
                                   const void* coarse, const void* residual, void* out, int B,
                                   int H, int Hkv, int Sq, int Sk, int D, int causal, int dtype,
                                   int tensor_core, float sm_scale, float step, float inv_step,
                                   int max_delta_int, int coarse_shift, int residual_mask,
                                   int coarse_entries, int residual_entries, float value_scale,
                                   void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  if (B < 0 || Sq < 0 || Sk < 0 || D < 1 || D > 256 || Hkv < 1 || H % Hkv || H / Hkv > kRows ||
      B > 65535 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const gn::ExpLut lut{step, inv_step, max_delta_int, coarse_shift, residual_mask,
                       coarse_entries, residual_entries, value_scale, 1.0f / value_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* co = static_cast<const float*>(coarse);
  const float* re = static_cast<const float*>(residual);
  if (tensor_core) {
    if (dtype != 1 || value_scale > 131072.0f)  // the hi + lo split is exact up to 2^-17
      return static_cast<int>(cudaErrorInvalidValue);
    return tc::dispatch(q, k, v, co, re, out, B, H, Hkv, Sq, Sk, D, causal, sm_scale, lut, s);
  }
  if (dtype == 0)
    return dispatch<float>(q, k, v, co, re, out, B, H, Hkv, Sq, Sk, D, causal, sm_scale, lut, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, co, re, out, B, H, Hkv, Sq, Sk, D, causal, sm_scale,
                                   lut, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
