// Chunked-query GN attention over a block-paged KV arena, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/gn_paged_attention/kernel.py
// (_gn_paged_attention_kernel, gn_paged_attention_pallas) in both its modes:
// fp arenas in q's type, and int8 arenas with per-physical-block f32 scales
// (kernel.py:97-104).  Query row i of sequence n sits at absolute position
// starts[n] + i and attends columns c with c <= starts[n] + i and c <
// length, length = starts[n] + n_valid[n]; blocks at or past `length` are
// never read (their table entries may name recycled or foreign blocks).  The
// online (m, l, acc) state follows the Pallas kernel (kernel.py:93-151): the
// running max snapped up to the Δ grid, LUT'd corrections, masked numerators
// exactly 0, and a final acc / l, so Σp = 1 to one rounding through any
// block layout.  Only the order of the f32 sums and the points where a
// correction is applied differ (the Q1.15 rounding of the corrections).
//
// Layout: the arenas are read in place in the pool's (nb, bs, Hkv, D)
// layout; nothing is transposed or padded per call.  One block serves one
// (sequence, kv head, chain range): all G = H / Hkv q heads and all C chunk
// rows, R = G * C rows (row r = g * C + i), so each K/V block is loaded from
// device memory once, not G times as the Pallas grid does.  The chain j = 0
// .. ceil(length/bs)-1 (the TPU's sequential grid axis) is cut into
// `splits` contiguous ranges, one block each, so a tick with few sequences
// still fills the card; a second kernel merges the ranges' (m, l, acc) with
// the same LUT'd corrections, one block per (sequence, kv head, row group),
// and skips the ranges that start past the live length.
//
// Bound: bytes.  A tick reads each live K/V block once (1 byte an element in
// int8 mode, plus one scale per block) and does about 4 * R * D flops per
// key, far below the card's flops-per-byte balance.
//
// Two designs, chosen by the caller (ops.py `design`):
// - tensor cores (tc:: below): bf16 q over bf16 or int8 arenas, D % 16 == 0,
//   R <= 64, LUT values of at most 17 bits, 16-byte aligned pointers.  Four
//   warps; each step takes a tile of 64 keys (four pages at bs = 16),
//   gathered page row by page row through the table with 16-byte cp.async
//   (each (page, slot) row of one kv head is D contiguous elements) into a
//   double buffer, so tile t+1's gather overlaps tile t's math, with one
//   barrier pair a tile.  The R rows make 1, 2 or 4 tiles of 16 rows; the
//   warps left over split each tile's keys into 4, 2 or 1 streams, each with
//   its own (m, l, acc), folded together at the end with the LUT'd
//   corrections.  S = q k^T and P V are mma.sync m16n8k16 bf16 -> f32 as in
//   gn_attention.cu: sm_scale after the dot, the GN update on the
//   accumulator fragment in registers, one product-LUT lookup a score, and
//   each numerator fed to P V as the exact sum hi + lo of two bf16, so acc
//   and l sum the same numerators.  int8: a tile lands as int8 and is
//   widened to bf16 in shared memory (|x| <= 127 is exact in bf16); each
//   score takes its page's k_scale after the dot, beside sm_scale; each
//   numerator is scaled by its page's v_scale in f32 before the split, so
//   P V sums y * v_scale * v (hi + lo keeps 16 of the product's 24 bits; l
//   sums the unscaled y).
// - CUDA cores (the first design): f32, and whatever the tensor-core design
//   does not take.  Each thread owns one column d of the head dim for its
//   loads, its queries and its share of acc; a dot product is split over a
//   group of lanes when a step has few (row, column) pairs (decode), the
//   online row update runs one warp per row, one page a step; an int8
//   element is dequantized in f32 right after its load.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// T: the type of q and out; KV: the arenas' type, T itself or int8_t (then
// k_scale and v_scale hold one f32 scale per physical block).
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
gn_paged_attention_kernel(const T* __restrict__ q, const KV* __restrict__ k_arena,
                          const KV* __restrict__ v_arena, const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale, const int* __restrict__ tables,
                          const int* __restrict__ starts, const int* __restrict__ n_valid,
                          const float* __restrict__ coarse_g,
                          const float* __restrict__ residual_g, T* __restrict__ out,
                          float* __restrict__ part_m, float* __restrict__ part_l,
                          float* __restrict__ part_acc, int C, int H, int Hkv, int D, int bs,
                          int max_bt, int split_blocks, int dot_lanes, float sm_scale,
                          gn::ExpLut lut) {
  const int n = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int G = H / Hkv, R = G * C, ld = D + 1;  // +1: no bank conflicts on rows
  // this thread's head-dim column, its first row, and the row stride
  const int d0 = tid % D, r0 = tid / D, rstep = kThreads / D;
  extern __shared__ float smem[];
  float* q_s = smem;                    // R x ld   scaled f32 queries
  float* acc_s = q_s + R * ld;          // R x D    running sum of y * v
  float* k_s = acc_s + R * D;           // bs x ld  this block's keys
  float* v_s = k_s + bs * ld;           // bs x D   this block's values
  float* y_s = v_s + bs * D;            // R x bs   scores, then numerators
  float* m_s = y_s + R * bs;            // R        running max (on the Δ grid)
  float* l_s = m_s + R;                 // R        running sum of numerators
  float* corr_s = l_s + R;              // R        this block's correction
  float* coarse = corr_s + R;           // the two exp ROM tables
  float* residual = coarse + lut.coarse_entries;

  for (int i = tid; i < lut.coarse_entries; i += kThreads) coarse[i] = coarse_g[i];
  for (int i = tid; i < lut.residual_entries; i += kThreads) residual[i] = residual_g[i];
  // row r = g * C + i: q head kvh * G + g at chunk row i
  for (int r = r0; r < R; r += rstep) {
    const int g = r / C, i = r % C;
    q_s[r * ld + d0] = gn::to_float(q[(((size_t)n * C + i) * H + kvh * G + g) * D + d0]) * sm_scale;
    acc_s[r * D + d0] = 0.0f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = gn::NEG_INF;
    l_s[r] = 0.0f;
  }
  const int start = starts[n];
  const int length = start + n_valid[n];
  // this block's range of the chain; blocks at or past `length` are never read
  const int j_end = min(min((length + bs - 1) / bs, max_bt), (split + 1) * split_blocks);
  const float max_corr = lut.step * (float)(lut.max_delta_int + 1);
  const int sub = lane & (dot_lanes - 1), pairs = R * bs, pair_step = kThreads / dot_lanes;
  __syncthreads();

  for (int j = split * split_blocks; j < j_end; ++j) {
    const size_t phys = (size_t)tables[(size_t)n * max_bt + j];
    if constexpr (std::is_same_v<KV, int8_t>) {
      // int8: one f32 product of the exact int8 value and the block's scale
      const float ks = k_scale[phys], vs = v_scale[phys];
      for (int t = r0; t < bs; t += rstep) {
        const size_t off = ((phys * bs + t) * Hkv + kvh) * D + d0;
        k_s[t * ld + d0] = gn::to_float(k_arena[off]) * ks;
        v_s[t * D + d0] = gn::to_float(v_arena[off]) * vs;
      }
    } else {
      for (int t = r0; t < bs; t += rstep) {
        const size_t off = ((phys * bs + t) * Hkv + kvh) * D + d0;
        k_s[t * ld + d0] = gn::to_float(k_arena[off]);
        v_s[t * D + d0] = gn::to_float(v_arena[off]);
      }
    }
    __syncthreads();

    // scores: one f32 dot per (row, column), split over `dot_lanes` lanes;
    // masked columns get NEG_INF.  The loop bound is uniform over the block,
    // so every lane of a warp reaches the shuffles.
    for (int base = 0; base < pairs; base += pair_step) {
      const int p = base + tid / dot_lanes;
      float part = 0.0f;
      bool visible = false;
      if (p < pairs) {
        const int r = p / bs, c = p % bs, col = j * bs + c;
        visible = col < length && col <= start + r % C;
        if (visible) {
          const float* qr = q_s + r * ld;
          const float* kc = k_s + c * ld;
          if (dot_lanes == 1) {
            for (int d = 0; d < D; ++d) part += qr[d] * kc[d];
          } else {
            for (int d = sub; d < D; d += dot_lanes) part += qr[d] * kc[d];
          }
        }
      }
      for (int o = dot_lanes >> 1; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (p < pairs && sub == 0) y_s[p] = visible ? part : gn::NEG_INF;
    }
    __syncthreads();

    // online update, one warp per row (kernel.py:120-140)
    for (int r = warp; r < R; r += kWarps) {
      const int qpos = start + r % C, col0 = j * bs;
      float* yr = y_s + r * bs;
      float m_cur = gn::NEG_INF;
      for (int c = lane; c < bs; c += 32) m_cur = fmaxf(m_cur, yr[c]);
      for (int o = 16; o > 0; o >>= 1) m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      const float m_old = m_s[r];
      // columns rise with c and both mask bounds are upper bounds, so the
      // row sees a valid column in this block iff it sees the first one
      const bool any_valid = col0 < length && col0 <= qpos;
      const bool started = m_old > gn::NEG_INF / 2;
      float m_new = gn::snap_up_to_grid(fmaxf(m_old, m_cur), lut.step);
      if (!(any_valid || started)) m_new = m_old;
      const float corr_delta = fminf(fmaxf(m_new - m_old, 0.0f), max_corr);
      const float corr =
          started ? gn::factorized_exp(corr_delta, coarse, residual, lut) : 0.0f;
      const bool live = m_new > gn::NEG_INF / 2;
      float sum = 0.0f;
      for (int c = lane; c < bs; c += 32) {
        const int col = col0 + c;
        float y = 0.0f;
        if (live && col < length && col <= qpos)
          y = gn::factorized_exp(fmaxf(m_new - yr[c], 0.0f), coarse, residual, lut);
        yr[c] = y;
        sum += y;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        corr_s[r] = corr;
      }
    }
    __syncthreads();

    for (int r = r0; r < R; r += rstep) {
      const float* yr = y_s + r * bs;
      float pv = 0.0f;
      for (int c = 0; c < bs; ++c) pv += yr[c] * v_s[c * D + d0];
      acc_s[r * D + d0] = acc_s[r * D + d0] * corr_s[r] + pv;
    }
    __syncthreads();
  }

  if (gridDim.z > 1) {  // hand this range's state to the merge kernel
    const size_t base = ((size_t)n * Hkv + kvh) * gridDim.z + split;
    for (int r = r0; r < R; r += rstep) {
      part_acc[(base * R + r) * D + d0] = acc_s[r * D + d0];
      if (d0 == 0) {
        part_m[base * R + r] = m_s[r];
        part_l[base * R + r] = l_s[r];
      }
    }
    return;
  }
  // guaranteed normalization: the LUT'd numerators over their own sum; an
  // empty row (l == 0) divides by 1 and stays 0
  for (int r = r0; r < R; r += rstep) {
    const int g = r / C, i = r % C;
    const float l = l_s[r] > 0.0f ? l_s[r] : 1.0f;
    out[(((size_t)n * C + i) * H + kvh * G + g) * D + d0] =
        gn::from_float<T>(acc_s[r * D + d0] * (1.0f / l));
  }
}

// Merge the chain ranges of one (sequence, kv head) for a group of rows: the
// grid-snapped max over the ranges, each range's (l, acc) times the LUT'd
// correction e^{-(m - m_s)} (0 for a range that saw nothing), summed in
// range order, then acc / l.  Ranges that start at or past the live length
// never ran and are skipped.  A row's max, then each (row, range)
// correction, land in shared memory first, so a thread's loads of its acc
// column over the ranges do not wait on each other.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_paged_attention_merge(const float* __restrict__ part_m, const float* __restrict__ part_l,
                         const float* __restrict__ part_acc, const int* __restrict__ starts,
                         const int* __restrict__ n_valid, const float* __restrict__ coarse,
                         const float* __restrict__ residual, T* __restrict__ out, int C, int H,
                         int Hkv, int D, int bs, int splits, int split_blocks, gn::ExpLut lut) {
  extern __shared__ float corr_s[];  // rstep x splits, then the rows' max
  const int n = blockIdx.x, kvh = blockIdx.y, tid = threadIdx.x;
  const int G = H / Hkv, R = G * C, rstep = kThreads / D, r0 = blockIdx.z * rstep;
  const int pages = (starts[n] + n_valid[n] + bs - 1) / bs;
  const int live = min(splits, (pages + split_blocks - 1) / split_blocks);
  const size_t base = ((size_t)n * Hkv + kvh) * splits;
  const float max_corr = lut.step * (float)(lut.max_delta_int + 1);
  float* m_s = corr_s + rstep * splits;
  if (tid < rstep && r0 + tid < R) {
    float m = gn::NEG_INF;
    for (int s = 0; s < live; ++s) m = fmaxf(m, part_m[(base + s) * R + r0 + tid]);
    m_s[tid] = m;
  }
  __syncthreads();
  for (int idx = tid; idx < rstep * live; idx += kThreads) {
    const int rr = idx / live, s = idx - rr * live;
    float corr = 0.0f;
    if (r0 + rr < R) {
      const float m = part_m[(base + s) * R + r0 + rr];
      if (m > gn::NEG_INF / 2)
        corr = gn::factorized_exp(fminf(fmaxf(m_s[rr] - m, 0.0f), max_corr), coarse, residual,
                                  lut);
    }
    corr_s[rr * splits + s] = corr;
  }
  __syncthreads();
  const int rr = tid / D, r = r0 + rr, d0 = tid % D;
  if (tid >= rstep * D || r >= R) return;
  float l = 0.0f, acc = 0.0f;
  for (int s = 0; s < live; ++s) {
    const float corr = corr_s[rr * splits + s];
    if (corr != 0.0f) {
      l = l + part_l[(base + s) * R + r] * corr;
      acc = acc + part_acc[((base + s) * R + r) * D + d0] * corr;
    }
  }
  const int g = r / C, i = r % C;
  out[(((size_t)n * C + i) * H + kvh * G + g) * D + d0] =
      gn::from_float<T>(acc * (1.0f / (l > 0.0f ? l : 1.0f)));
}

// One block per (sequence, kv head, group of 256 / D rows).
template <typename T>
int launch_merge(const float* part_m, const float* part_l, const float* part_acc,
                 const int* starts, const int* n_valid, const float* coarse,
                 const float* residual, void* out, int N, int C, int H, int Hkv, int D, int bs,
                 int splits, int split_blocks, const gn::ExpLut& lut, cudaStream_t stream) {
  const int rstep = kThreads / D, R = (H / Hkv) * C;
  const size_t smem = (size_t)rstep * (splits + 1) * sizeof(float);
  gn_paged_attention_merge<T><<<dim3(N, Hkv, (R + rstep - 1) / rstep), kThreads, smem, stream>>>(
      part_m, part_l, part_acc, starts, n_valid, coarse, residual, static_cast<T*>(out), C, H,
      Hkv, D, bs, splits, split_blocks, lut);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV>
int launch(const void* q, const void* k, const void* v, const float* k_scale,
           const float* v_scale, const int* tables, const int* starts,
           const int* n_valid, const float* coarse, const float* residual, void* out,
           float* part_m, float* part_l, float* part_acc, int N, int C, int H, int Hkv, int D,
           int bs, int max_bt, int splits, int split_blocks, int dot_lanes, float sm_scale,
           const gn::ExpLut& lut, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gn_paged_attention_kernel<T, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gn_paged_attention_kernel<T, KV><<<dim3(N, Hkv, splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v), k_scale,
      v_scale, tables, starts, n_valid, coarse, residual, static_cast<T*>(out), part_m, part_l,
      part_acc, C, H, Hkv, D, bs, max_bt, split_blocks, dot_lanes, sm_scale, lut);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  return launch_merge<T>(part_m, part_l, part_acc, starts, n_valid, coarse, residual, out, N, C,
                         H, Hkv, D, bs, splits, split_blocks, lut, stream);
}

// ------------------------------------------------------- tensor cores (bf16) --
namespace tc {

using gn::bf16;
using gn::cp_async16;
using gn::cp_async_commit;
using gn::cp_async_wait;
using gn::ldsm_x4;
using gn::ldsm_x4_trans;
using gn::mma;
using gn::quad_max;
using gn::quad_sum;
using gn::split;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 64;  // keys a tile: four pages at block size 16

// Shared memory past the q rows: fp, two stages of bf16 K and V tiles read in
// place; int8, two stages of int8 tiles and their per-key scales, and the
// bf16 tiles (and scales) the warps read.  After the walk it holds the key
// streams' (acc, m, l) for the fold.
template <int DP, bool INT8>
__host__ __device__ constexpr size_t kv_bytes() {
  return INT8 ? (size_t)4 * kKeys * DP + (size_t)2 * kKeys * (DP + 8) * sizeof(bf16) +
                    (size_t)6 * kKeys * sizeof(float)
              : (size_t)4 * kKeys * (DP + 8) * sizeof(bf16);
}

// 16 int8 values widened to 16 bf16 (exact: |x| <= 127)
__device__ __forceinline__ void widen16(bf16* dst, const int8_t* src) {
  const int4 raw = *reinterpret_cast<const int4*>(src);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    w[j] = gn::pack(__float2bfloat16_rn((float)b[2 * j]), __float2bfloat16_rn((float)b[2 * j + 1]));
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// DP: head dim padded to the instantiation (64, 128, 256); KS: key streams
// (4 / the row tiles); INT8: int8 arenas with per-block scales.
template <int DP, int KS, bool INT8>
__global__ void __launch_bounds__(kThreads, DP <= 128 ? 2 : 1)
gn_paged_attention_tc_kernel(const bf16* __restrict__ q, const void* __restrict__ k_arena,
                             const void* __restrict__ v_arena, const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale, const int* __restrict__ tables,
                             const int* __restrict__ starts, const int* __restrict__ n_valid,
                             const float* __restrict__ coarse_g,
                             const float* __restrict__ residual_g, bf16* __restrict__ out,
                             float* __restrict__ part_m, float* __restrict__ part_l,
                             float* __restrict__ part_acc, int C, int H, int Hkv, int D, int bs,
                             int max_bt, int split_blocks, float sm_scale, gn::ExpLut lut) {
  using KV = std::conditional_t<INT8, int8_t, bf16>;
  constexpr int RT = 4 / KS;              // 16-row tiles
  constexpr int QR = 16 * RT;             // q rows staged
  constexpr int KW = kKeys / KS;          // keys a warp takes of each tile
  constexpr int NT = KW / 8;              // score n-tiles a warp
  constexpr int LD = DP + 8;              // bf16 row stride: ldmatrix's rows hit 8 bank groups
  constexpr int CH = DP / 8;              // 16-byte chunks of a bf16 row
  constexpr int EL = 16 / sizeof(KV);     // arena elements a 16-byte chunk
  constexpr int KCH = DP / EL;            // 16-byte chunks of an arena row
  constexpr int XS = (DP / 2 + 4) * 32;   // floats a stream hands to the fold
  static_assert((KS - 1) * RT * XS * sizeof(float) <= kv_bytes<DP, INT8>(), "fold scratch");
  const int n = blockIdx.x, kvh = blockIdx.y, range = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int rt = warp % RT, ks = warp / RT;  // this warp's row tile and key stream
  const int G = H / Hkv, R = G * C, dk = D >> 4;
  const int start = starts[n], length = start + n_valid[n];
  // this block's pages; none at or past ceil(length / bs) is ever gathered
  const int j0 = range * split_blocks;
  const int j1 = min(min((length + bs - 1) / bs, max_bt), j0 + split_blocks);
  if (j0 >= j1) {  // no live page: the merge skips the range; an empty chain reads 0
    if (gridDim.z == 1)
      for (int idx = tid; idx < R * D; idx += kThreads) {
        const int r = idx / D, d = idx - r * D;
        out[(((size_t)n * C + r % C) * H + kvh * G + r / C) * D + d] = __float2bfloat16_rn(0.0f);
      }
    return;
  }
  const int c_begin = j0 * bs, c_end = min(j1 * bs, length);
  const int n_tiles = (c_end - c_begin + kKeys - 1) / kKeys;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // QR x LD
  unsigned char* kv_raw = smem_raw + (size_t)QR * LD * sizeof(bf16);
  // fp: 2 stages x kKeys x LD each; int8: 2 stages x kKeys x DP each
  KV* k_st = reinterpret_cast<KV*>(kv_raw);
  KV* v_st = k_st + 2 * kKeys * (INT8 ? DP : LD);
  // int8 only: the widened tile, the staged and the widened per-key scales
  bf16* k_w = reinterpret_cast<bf16*>(v_st + 2 * kKeys * (INT8 ? DP : LD));
  bf16* v_w = k_w + kKeys * LD;
  float* ksc_st = reinterpret_cast<float*>(v_w + kKeys * LD);
  float* vsc_st = ksc_st + 2 * kKeys;
  float* ksc = vsc_st + 2 * kKeys;
  float* vsc = ksc + kKeys;
  float* table = reinterpret_cast<float*>(kv_raw + kv_bytes<DP, INT8>());

  // the two ROM tables expanded into their product table, the saturated 0
  // last: one lookup a score
  for (int d = tid; d <= lut.max_delta_int + 1; d += kThreads)
    table[d] = d > lut.max_delta_int ? 0.0f : gn::exp_entry(d, coarse_g, residual_g, lut);
  for (int idx = tid; idx < QR * CH; idx += kThreads) {
    const int r = idx / CH, c = idx - r * CH;
    const bool in = r < R && c < 2 * dk;
    const bf16* row = q + (((size_t)n * C + (in ? r % C : 0)) * H + kvh * G + (in ? r / C : 0)) * D;
    cp_async16(q_s + r * LD + 8 * c, in ? row + 8 * c : q, in);
  }
  // tile t's page rows into stage st: key slot tt is column c_begin + t *
  // kKeys + tt, slot col % bs of page col / bs; slots past c_end are zeros
  auto gather = [&](int t, int st) {
    const int c0 = c_begin + t * kKeys;
    const KV* ka = static_cast<const KV*>(k_arena);
    const KV* va = static_cast<const KV*>(v_arena);
    for (int idx = tid; idx < kKeys * KCH; idx += kThreads) {
      const int tt = idx / KCH, c = idx - tt * KCH, col = c0 + tt;
      const bool in = col < c_end && c * EL < D;
      size_t off = 0;
      if (in) {
        const int j = col / bs;
        off = (((size_t)tables[(size_t)n * max_bt + j] * bs + (col - j * bs)) * Hkv + kvh) * D +
              (size_t)c * EL;
      }
      const int dst = (st * kKeys + tt) * (INT8 ? DP : LD) + c * EL;
      cp_async16(k_st + dst, ka + off, in);
      cp_async16(v_st + dst, va + off, in);
    }
    if constexpr (INT8) {
      for (int tt = tid; tt < kKeys; tt += kThreads) {
        const int col = c0 + tt;
        float a = 0.0f, b = 0.0f;
        if (col < c_end) {
          const int phys = tables[(size_t)n * max_bt + col / bs];
          a = k_scale[phys];
          b = v_scale[phys];
        }
        ksc_st[st * kKeys + tt] = a;
        vsc_st[st * kKeys + tt] = b;
      }
    }
  };

  // this lane's two rows (gid and gid + 8 of the warp's row tile): whether
  // they exist and the last column each may see
  int lim[2];
  bool rv[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rt * 16 + gid + 8 * i;
    rv[i] = r < R;
    lim[i] = min(c_end - 1, start + r % C);
    m[i] = gn::NEG_INF;
    l[i] = 0.0f;
  }
  const int lim_min = min(rv[0] ? lim[0] : -1, rv[1] ? lim[1] : -1);
  float acc[DP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  const float max_corr = lut.step * (float)(lut.max_delta_int + 1);

  gather(0, 0);
  cp_async_commit();  // q and the first tile
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      gather(t + 1, st ^ 1);  // the other stage, free since the end of tile t - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt_s;
    const bf16* vt_s;
    if constexpr (INT8) {
      // widen the tile and take its scales; every warp is past tile t - 1
      for (int idx = tid; idx < kKeys * (DP / 16); idx += kThreads) {
        const int tt = idx / (DP / 16), c = idx - tt * (DP / 16);
        if (16 * c >= D) continue;
        widen16(k_w + tt * LD + 16 * c, k_st + (st * kKeys + tt) * DP + 16 * c);
        widen16(v_w + tt * LD + 16 * c, v_st + (st * kKeys + tt) * DP + 16 * c);
      }
      for (int tt = tid; tt < kKeys; tt += kThreads) {
        ksc[tt] = ksc_st[st * kKeys + tt];
        vsc[tt] = vsc_st[st * kKeys + tt];
      }
      __syncthreads();
      kt_s = k_w;
      vt_s = v_w;
    } else {
      kt_s = k_st + st * kKeys * LD;
      vt_s = v_st + st * kKeys * LD;
    }
    const int k0 = ks * KW;                        // this warp's first key of the tile
    const int c0 = c_begin + t * kKeys + k0;       // and its column
    if (c0 < c_end) {
      // S = q k^T over the head-dim steps that hold data
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < DP / 16; ++kt) {
        if (kt >= dk) break;
        uint32_t a[4];
        ldsm_x4(a, q_s + (rt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kt * 16 +
                       (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bk[4];
          ldsm_x4(bk, kt_s + (k0 + np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kt * 16 +
                          ((lane >> 3) & 1) * 8);
          mma(s[2 * np], a, bk[0], bk[1]);
          mma(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }

      // online update of the lane's two rows (kernel.py:120-140); element e
      // of n-tile nt is row gid + 8 (e >> 1), key k0 + 8 nt + 2 tig + (e & 1).
      // int8: the key's k_scale, then sm_scale, after the dot.  Masked
      // scores become NEG_INF; a slice every row of the warp sees whole
      // skips the mask.
      float mx[2] = {gn::NEG_INF, gn::NEG_INF};
      const bool whole = __all_sync(0xffffffffu, c0 + KW - 1 <= lim_min);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, kk = 8 * nt + 2 * tig + (e & 1);
          float x = s[nt][e];
          if constexpr (INT8) x = x * ksc[k0 + kk];
          x = x * sm_scale;
          if (!whole && !(rv[i] && c0 + kk <= lim[i])) x = gn::NEG_INF;
          s[nt][e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      float corr[2];
      bool live[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_cur = quad_max(mx[i]);
        // both mask bounds are upper bounds on the column, so a row sees some
        // column of this slice iff it sees the first one
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
      // numerators: a masked score's Δ saturates to exactly 0, a row that
      // has seen nothing takes none; l sums y, P V takes y (int8: y times
      // the key's v_scale, in f32)
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float y = table[gn::exp_index(fmaxf(m[i] - s[nt][e], 0.0f), lut)];
          y = live[i] ? y : 0.0f;
          sum[i] += y;
          if constexpr (INT8) y = y * vsc[k0 + 8 * nt + 2 * tig + (e & 1)];
          s[nt][e] = y;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(sum[i]);
      // x * 1 == x: the rescale runs only where a row of the warp moved its max
      if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
        for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] *= corr[e >> 1];
      }

      // acc += y v (kernel.py:137-139), y = hi + lo: n-tiles 2 kk and
      // 2 kk + 1 of S are the A fragment of key step kk
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int nd = 0; nd < DP / 16; ++nd) {
          if (nd >= dk) break;
          uint32_t bv[4];
          ldsm_x4_trans(bv, vt_s + (k0 + kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                nd * 16 + (lane >> 4) * 8);
          mma(acc[2 * nd], ph, bv[0], bv[1]);
          mma(acc[2 * nd], pl, bv[0], bv[1]);
          mma(acc[2 * nd + 1], ph, bv[2], bv[3]);
          mma(acc[2 * nd + 1], pl, bv[2], bv[3]);
        }
      }
    }
    if constexpr (!INT8) __syncthreads();  // every warp is done with this stage
  }

  // fold the key streams of each row tile into stream 0: the grid-snapped
  // max, each stream's (l, acc) times its LUT'd correction (0 for a stream
  // that saw nothing), in stream order, through shared memory
  if constexpr (KS > 1) {
    __syncthreads();  // the tiles are free
    float* xs = reinterpret_cast<float*>(kv_raw);
    if (ks > 0) {
      float* x = xs + (warp - RT) * XS;
#pragma unroll
      for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[(nt * 4 + e) * 32 + lane] = acc[nt][e];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        x[(DP / 2 + i) * 32 + lane] = m[i];
        x[(DP / 2 + 2 + i) * 32 + lane] = l[i];
      }
    }
    __syncthreads();
    if (ks > 0) return;
    float mm[2] = {m[0], m[1]};
#pragma unroll
    for (int sk = 1; sk < KS; ++sk)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mm[i] = fmaxf(mm[i], xs[((sk - 1) * RT + rt) * XS + (DP / 2 + i) * 32 + lane]);
    auto corr_to = [&](float ms, float mt) {
      return ms > gn::NEG_INF / 2
                 ? table[gn::exp_index(fminf(fmaxf(mt - ms, 0.0f), max_corr), lut)]
                 : 0.0f;
    };
    float c[2] = {corr_to(m[0], mm[0]), corr_to(m[1], mm[1])};
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * c[i];
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= c[e >> 1];
#pragma unroll
    for (int sk = 1; sk < KS; ++sk) {
      const float* x = xs + ((sk - 1) * RT + rt) * XS;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        c[i] = corr_to(x[(DP / 2 + i) * 32 + lane], mm[i]);
        l[i] = l[i] + x[(DP / 2 + 2 + i) * 32 + lane] * c[i];
      }
#pragma unroll
      for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = acc[nt][e] + x[(nt * 4 + e) * 32 + lane] * c[e >> 1];
    }
    m[0] = mm[0];
    m[1] = mm[1];
  }

  if (gridDim.z > 1) {  // hand this range's state to the merge kernel
    const size_t base = ((size_t)n * Hkv + kvh) * gridDim.z + range;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rt * 16 + gid + 8 * i;
      if (r >= R) continue;
      if (tig == 0) {
        part_m[base * R + r] = m[i];
        part_l[base * R + r] = l[i];
      }
      float* arow = part_acc + (base * R + r) * D;
#pragma unroll
      for (int nt = 0; nt < DP / 8; ++nt) {
        const int d = 8 * nt + 2 * tig;
        if (d < D) *reinterpret_cast<float2*>(arow + d) = make_float2(acc[nt][2 * i], acc[nt][2 * i + 1]);
      }
    }
    return;
  }
  // guaranteed normalization: the LUT'd numerators over their own sum; a row
  // that saw nothing (l == 0) divides by 1 and stays 0
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rt * 16 + gid + 8 * i;
    if (r >= R) continue;
    const float inv = 1.0f / (l[i] > 0.0f ? l[i] : 1.0f);
    bf16* orow = out + (((size_t)n * C + r % C) * H + kvh * G + r / C) * D;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      const int d = 8 * nt + 2 * tig;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(acc[nt][2 * i] * inv, acc[nt][2 * i + 1] * inv);
    }
  }
}

template <int DP, int KS, bool INT8>
int launch(const void* q, const void* k, const void* v, const float* k_scale,
           const float* v_scale, const int* tables, const int* starts, const int* n_valid,
           const float* coarse, const float* residual, void* out, float* part_m, float* part_l,
           float* part_acc, int N, int C, int H, int Hkv, int D, int bs, int max_bt, int splits,
           int split_blocks, float sm_scale, const gn::ExpLut& lut, cudaStream_t stream) {
  const size_t smem = (size_t)(64 / KS) * (DP + 8) * sizeof(bf16) + kv_bytes<DP, INT8>() +
                      (size_t)(lut.max_delta_int + 2) * sizeof(float);
  auto kernel = gn_paged_attention_tc_kernel<DP, KS, INT8>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(N, Hkv, splits), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), k, v, k_scale, v_scale, tables, starts, n_valid, coarse,
      residual, static_cast<bf16*>(out), part_m, part_l, part_acc, C, H, Hkv, D, bs, max_bt,
      split_blocks, sm_scale, lut);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  return launch_merge<bf16>(part_m, part_l, part_acc, starts, n_valid, coarse, residual, out, N,
                            C, H, Hkv, D, bs, splits, split_blocks, lut, stream);
}

// the instantiation for (D, R, mode): DP the padded head dim, KS = 4 / row tiles
template <bool INT8>
int dispatch(const void* q, const void* k, const void* v, const float* k_scale,
             const float* v_scale, const int* tables, const int* starts, const int* n_valid,
             const float* coarse, const float* residual, void* out, float* part_m,
             float* part_l, float* part_acc, int N, int C, int H, int Hkv, int D, int bs,
             int max_bt, int splits, int split_blocks, float sm_scale, const gn::ExpLut& lut,
             cudaStream_t stream) {
  const int R = (H / Hkv) * C;
  auto go = [&](auto dp, auto streams) {
    return launch<decltype(dp)::value, decltype(streams)::value, INT8>(
        q, k, v, k_scale, v_scale, tables, starts, n_valid, coarse, residual, out, part_m,
        part_l, part_acc, N, C, H, Hkv, D, bs, max_bt, splits, split_blocks, sm_scale, lut,
        stream);
  };
  using I64 = std::integral_constant<int, 64>;
  using I128 = std::integral_constant<int, 128>;
  using I256 = std::integral_constant<int, 256>;
  using K4 = std::integral_constant<int, 4>;
  using K2 = std::integral_constant<int, 2>;
  using K1 = std::integral_constant<int, 1>;
  auto by_rows = [&](auto dp) {
    if (R <= 16) return go(dp, K4{});
    if (R <= 32) return go(dp, K2{});
    return go(dp, K1{});
  };
  if (D <= 64) return by_rows(I64{});
  if (D <= 128) return by_rows(I128{});
  return by_rows(I256{});
}

}  // namespace tc

}  // namespace

// q, out: (N, C, H, D) contiguous, f32 (dtype 0) or bf16 (dtype 1); k, v:
// (nb, bs, Hkv, D) contiguous arenas, of q's dtype (kv_dtype == dtype, and
// k_scale, v_scale null) or int8 (kv_dtype 2, and k_scale, v_scale the
// (nb,) f32 per-block scales); D must divide 256;
// tables: (N, max_bt) int32; starts, n_valid: (N,) int32; coarse, residual:
// the f32 exp ROM tables.  The chain is cut into `splits` ranges of
// `split_blocks` blocks; with splits > 1, part_m and part_l (N, Hkv, splits,
// R) and part_acc (N, Hkv, splits, R, D) are f32 scratch, R = (H/Hkv) * C.
// The caller names the design (ops.py `design`): tensor_core 1 runs the
// tensor-core design, which takes bf16 q, D % 16 == 0, R <= 64, LUT values of
// at most 17 bits (value_scale <= 2^17) and q, k, v, out on 16-byte
// boundaries, and refuses anything else; tensor_core 0 runs the CUDA-core
// design.  Launches on `stream` and returns cudaGetLastError() (or the error
// of the shared-memory opt-in).
extern "C" int gn_paged_attention_launch(
    const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
    const void* tables, const void* starts, const void* n_valid, const void* coarse,
    const void* residual, void* out, void* part_m, void* part_l, void* part_acc, int N, int C,
    int H, int Hkv, int D, int bs, int max_bt, int splits, int split_blocks, int dtype,
    int kv_dtype, int tensor_core, float sm_scale, float step, float inv_step,
    int max_delta_int, int coarse_shift, int residual_mask, int coarse_entries,
    int residual_entries, float value_scale, void* stream) {
  if (N == 0) return static_cast<int>(cudaGetLastError());
  const bool quant = kv_dtype == 2;
  if (D < 1 || kThreads % D || splits < 1 ||
      (splits - 1) * split_blocks >= (max_bt > 1 ? max_bt : 1) ||
      (!quant && kv_dtype != dtype) || quant != (k_scale != nullptr) ||
      quant != (v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const gn::ExpLut lut{step, inv_step, max_delta_int, coarse_shift, residual_mask,
                       coarse_entries, residual_entries, value_scale, 1.0f / value_scale};
  const int R = (H / Hkv) * C;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* t = static_cast<const int*>(tables);
  const int* st = static_cast<const int*>(starts);
  const int* nv = static_cast<const int*>(n_valid);
  const float* co = static_cast<const float*>(coarse);
  const float* re = static_cast<const float*>(residual);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_core) {
    auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
    if (dtype != 1 || D % 16 || D > 256 || R > 64 || value_scale > 131072.0f || !aligned(q) ||
        !aligned(k) || !aligned(v) || !aligned(out))
      return static_cast<int>(cudaErrorInvalidValue);
    return quant ? tc::dispatch<true>(q, k, v, ks, vs, t, st, nv, co, re, out, pm, pl, pa, N, C,
                                      H, Hkv, D, bs, max_bt, splits, split_blocks, sm_scale, lut,
                                      s)
                 : tc::dispatch<false>(q, k, v, ks, vs, t, st, nv, co, re, out, pm, pl, pa, N,
                                       C, H, Hkv, D, bs, max_bt, splits, split_blocks, sm_scale,
                                       lut, s);
  }
  // lanes per dot: as many as keep all threads busy on a step's R * bs pairs
  int dot_lanes = 1;
  while (dot_lanes < 32 && 2 * dot_lanes * R * bs <= kThreads) dot_lanes *= 2;
  const size_t floats = (size_t)R * (D + 1) + (size_t)R * D + (size_t)bs * (D + 1) +
                        (size_t)bs * D + (size_t)R * bs + 3 * (size_t)R + coarse_entries +
                        residual_entries;
  const size_t smem = floats * sizeof(float);
  // instantiate the (q, arena) type pair the codes name
  auto go = [&](auto q_type, auto kv_type) {
    return launch<decltype(q_type), decltype(kv_type)>(
        q, k, v, ks, vs, t, st, nv, co, re, out, pm, pl, pa, N, C, H, Hkv, D, bs, max_bt,
        splits, split_blocks, dot_lanes, sm_scale, lut, smem, s);
  };
  if (dtype == 0) return quant ? go(float{}, int8_t{}) : go(float{}, float{});
  if (dtype == 1)
    return quant ? go(__nv_bfloat16{}, int8_t{}) : go(__nv_bfloat16{}, __nv_bfloat16{});
  return static_cast<int>(cudaErrorInvalidValue);
}
