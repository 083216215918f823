// Chunked-query GN attention over a block-paged KV arena, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/gn_paged_attention/kernel.py
// (_gn_paged_attention_kernel, gn_paged_attention_pallas) in its fp mode.
// Query row i of sequence n sits at absolute position starts[n] + i and
// attends columns c with c <= starts[n] + i and c < length, length =
// starts[n] + n_valid[n]; blocks at or past `length` are never read (their
// table entries may name recycled or foreign blocks).  The online
// (m, l, acc) state follows the Pallas kernel line for line
// (kernel.py:93-151): q scaled before an f32 dot, the running max snapped up
// to the Δ grid, LUT'd corrections, masked numerators exactly 0, and a final
// acc / l, so Σp = 1 to one rounding through any block layout.  Only the
// order of the f32 sums differs, as in any parallel reduction.
//
// Layout: the arenas are read in place in the pool's (nb, bs, Hkv, D)
// layout; nothing is transposed or padded per call.  One block serves one
// (sequence, kv head) pair: all G = H / Hkv q heads and all C chunk rows,
// R = G * C rows, so each K/V block is loaded from device memory once, not G
// times as the Pallas grid does.  The chain j = 0 .. ceil(length/bs)-1 (the
// TPU's sequential grid axis) is cut into `splits` contiguous ranges, one
// block each, so a tick with few sequences still fills the card; each range
// runs the online update in order, and a second kernel merges the ranges'
// (m, l, acc) with the same LUT'd corrections the online update uses.  Each
// thread owns one column d of the head dim for its loads, its queries and
// its share of acc; a dot product is split over a group of lanes when a step
// has few (row, column) pairs (decode), and the online row update runs one
// warp per row.
//
// Bound: bytes.  A tick reads each live K/V block once and does about
// 4 * R * D flops per key, far below the card's flops-per-byte balance.
// This version is still the simple one: f32 CUDA-core dots, no tensor
// cores, no TMA, no overlap of the next block's load with this block's math.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_arena,
                          const T* __restrict__ v_arena, const int* __restrict__ tables,
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
    for (int t = r0; t < bs; t += rstep) {
      const size_t off = ((phys * bs + t) * Hkv + kvh) * D + d0;
      k_s[t * ld + d0] = gn::to_float(k_arena[off]);
      v_s[t * D + d0] = gn::to_float(v_arena[off]);
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

// Merge the chain ranges of one (sequence, kv head): the grid-snapped max
// over the ranges, each range's (l, acc) times the LUT'd correction
// e^{-(m - m_s)} (0 for a range that saw nothing), then acc / l.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_paged_attention_merge(const float* __restrict__ part_m, const float* __restrict__ part_l,
                         const float* __restrict__ part_acc, const float* __restrict__ coarse,
                         const float* __restrict__ residual, T* __restrict__ out, int C, int H,
                         int Hkv, int D, int splits, gn::ExpLut lut) {
  const int n = blockIdx.x, kvh = blockIdx.y, tid = threadIdx.x;
  const int G = H / Hkv, R = G * C, d0 = tid % D, r0 = tid / D, rstep = kThreads / D;
  const size_t base = ((size_t)n * Hkv + kvh) * splits;
  const float max_corr = lut.step * (float)(lut.max_delta_int + 1);
  for (int r = r0; r < R; r += rstep) {
    float m = gn::NEG_INF;
    for (int s = 0; s < splits; ++s) m = fmaxf(m, part_m[(base + s) * R + r]);
    float l = 0.0f, acc = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const float m_s = part_m[(base + s) * R + r];
      if (m_s > gn::NEG_INF / 2) {
        const float corr =
            gn::factorized_exp(fminf(fmaxf(m - m_s, 0.0f), max_corr), coarse, residual, lut);
        l = l + part_l[(base + s) * R + r] * corr;
        acc = acc + part_acc[((base + s) * R + r) * D + d0] * corr;
      }
    }
    const int g = r / C, i = r % C;
    out[(((size_t)n * C + i) * H + kvh * G + g) * D + d0] =
        gn::from_float<T>(acc * (1.0f / (l > 0.0f ? l : 1.0f)));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* tables, const int* starts,
           const int* n_valid, const float* coarse, const float* residual, void* out,
           float* part_m, float* part_l, float* part_acc, int N, int C, int H, int Hkv, int D,
           int bs, int max_bt, int splits, int split_blocks, int dot_lanes, float sm_scale,
           const gn::ExpLut& lut, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gn_paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gn_paged_attention_kernel<T><<<dim3(N, Hkv, splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), tables,
      starts, n_valid, coarse, residual, static_cast<T*>(out), part_m, part_l, part_acc, C, H,
      Hkv, D, bs, max_bt, split_blocks, dot_lanes, sm_scale, lut);
  if (splits > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    gn_paged_attention_merge<T><<<dim3(N, Hkv), kThreads, 0, stream>>>(
        part_m, part_l, part_acc, coarse, residual, static_cast<T*>(out), C, H, Hkv, D, splits,
        lut);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (N, C, H, D) contiguous; k, v: (nb, bs, Hkv, D) contiguous arenas of
// the same dtype, f32 (dtype 0) or bf16 (dtype 1); D must divide 256;
// tables: (N, max_bt) int32; starts, n_valid: (N,) int32; coarse, residual:
// the f32 exp ROM tables.  The chain is cut into `splits` ranges of
// `split_blocks` blocks; with splits > 1, part_m and part_l (N, Hkv, splits,
// R) and part_acc (N, Hkv, splits, R, D) are f32 scratch, R = (H/Hkv) * C.
// Launches on `stream` and returns cudaGetLastError() (or the error of the
// shared-memory opt-in).
extern "C" int gn_paged_attention_launch(
    const void* q, const void* k, const void* v, const void* tables, const void* starts,
    const void* n_valid, const void* coarse, const void* residual, void* out, void* part_m,
    void* part_l, void* part_acc, int N, int C, int H, int Hkv, int D, int bs, int max_bt,
    int splits, int split_blocks, int dtype, float sm_scale, float step, float inv_step,
    int max_delta_int, int coarse_shift, int residual_mask, int coarse_entries,
    int residual_entries, float value_scale, void* stream) {
  if (N == 0) return static_cast<int>(cudaGetLastError());
  if (D < 1 || kThreads % D || splits < 1 ||
      (splits - 1) * split_blocks >= (max_bt > 1 ? max_bt : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const gn::ExpLut lut{step, inv_step, max_delta_int, coarse_shift, residual_mask,
                       coarse_entries, residual_entries, value_scale, 1.0f / value_scale};
  const int R = (H / Hkv) * C;
  // lanes per dot: as many as keep all threads busy on a step's R * bs pairs
  int dot_lanes = 1;
  while (dot_lanes < 32 && 2 * dot_lanes * R * bs <= kThreads) dot_lanes *= 2;
  const size_t floats = (size_t)R * (D + 1) + (size_t)R * D + (size_t)bs * (D + 1) +
                        (size_t)bs * D + (size_t)R * bs + 3 * (size_t)R + coarse_entries +
                        residual_entries;
  const size_t smem = floats * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* st = static_cast<const int*>(starts);
  const int* nv = static_cast<const int*>(n_valid);
  const float* co = static_cast<const float*>(coarse);
  const float* re = static_cast<const float*>(residual);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == 0)
    return launch<float>(q, k, v, t, st, nv, co, re, out, pm, pl, pa, N, C, H, Hkv, D, bs,
                         max_bt, splits, split_blocks, dot_lanes, sm_scale, lut, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, t, st, nv, co, re, out, pm, pl, pa, N, C, H, Hkv,
                                 D, bs, max_bt, splits, split_blocks, dot_lanes, sm_scale,
                                 lut, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
