// Dequant + inverse transform of every transform unit of a frame, written
// into the bordered int16 residual planes.
//
// Replaces: xevd_tpu/ops/jax_itdq.py `itdq_bucket` (K1: the Baseline DCT-2,
// the Main `iqt` DCT-2 and the ATS `trs` DST-7/DCT-8 variants) fused with
// xevd_tpu/ops/pipeline.py `_itdq_all` (K2: coefficient gather and residual
// scatter).  Arithmetic: int64 dequant clipped to int16, then
// - Baseline (xevd_tpu/ops/ref_numpy.py `itdq_block`): stage 0 clipped to
//   +-(2^31-1), stage 1 with the combined shift 27 - bd, clipped to
//   [MIN_TX_VAL, MAX_TX_VAL];
// - Main, when the frame has `iqt` or the TU a nonzero `trs`
//   (jax_itdq.py:75-95): stage 0 (s + 64) >> 7 clipped to int16, stage 1
//   shifted by 20 - bd with rounding, clipped to int16.  trs =
//   ((th + 1) << 2) | (tv + 1) picks the DST-7 (0) or DCT-8 (1) basis for
//   the width (th) and the height (tv) axis; trs 0 is the DCT-2.
//
// Bound on the H100: integer multiply-adds.  A 64x64 TU needs 2 * 64^3
// MACs; the coefficients and residuals are 4 bytes a sample, read and
// written once.  The JAX version split every wide product into 12- and
// 16-bit halves because the TPU has no fast int64; here the products are
// plain 64-bit integer arithmetic (emulated by the SM, but exact).
//
// Design: one launch per frame over the TU table; one CTA per TU, so TUs
// of every size and transform share the launch (no per-size or per-trs
// buckets).  The CTA stages the two n-point bases (the DCT-2 taken from the
// 64-point basis: TMn[k][j] = TM64[k << (6 - log2 n)][j]; the ATS bases
// from their [2][6][32][32] table), the dequantized block and the stage-0
// result in shared memory (40 KB at 64x64), then each thread computes its
// outputs of each stage with a strided loop.  Main stages stay within
// int32 (jax_itdq.py:76-77); the accumulators stay int64 for both paths.
// Small TUs leave most threads idle; packing several small TUs per CTA is
// later work.
//
// GOP batch (K15): the TU table holds the TUs of the G frames of one time
// step, those of frame g at rows tu_off[g] .. tu_off[g + 1] - 1; a CTA finds
// its row's g (batch.cuh) and reads and writes that frame's planes, at g
// times each plane's batch stride.  Still one launch a step.
#include <cuda_runtime.h>
#include <stdint.h>

#include "batch.cuh"

#define BORDER 72
#define MIN_TX_VAL (-32768)
#define MAX_TX_VAL 32767
#define ITDQ_THREADS 256

namespace {

__device__ __forceinline__ long long clamp64(long long v, long long lo,
                                             long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The n-point basis of one axis into shared memory: kind -1 the DCT-2
// from the 64-point basis, 0 the DST-7, 1 the DCT-8 (n <= 32).
__device__ __forceinline__ void load_basis(int16_t* s_tm, int lg, int kind,
                                           const int32_t* __restrict__ tm64,
                                           const int32_t* __restrict__ tr) {
  const int n = 1 << lg;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int k = i >> lg, j = i & (n - 1);
    s_tm[i] = (int16_t)(kind < 0 ? tm64[(k << (6 - lg)) * 64 + j]
                                 : tr[((kind * 6 + lg) * 32 + k) * 32 + j]);
  }
}

// TU row: comp, log2w, log2h, scale, y, x, trs
__global__ void __launch_bounds__(ITDQ_THREADS)
itdq_kernel(const int16_t* __restrict__ coef_y,
            const int16_t* __restrict__ coef_u,
            const int16_t* __restrict__ coef_v, int cs_y, int cs_c,
            int16_t* __restrict__ res_y, int16_t* __restrict__ res_u,
            int16_t* __restrict__ res_v, int rs_y, int rs_c,
            const int32_t* __restrict__ tus,
            const int32_t* __restrict__ tm64,
            const int32_t* __restrict__ tr, int bd, int iqt,
            const int32_t* __restrict__ tu_off, int G, long long cbs_y,
            long long cbs_c, long long rbs_y, long long rbs_c) {
  __shared__ int16_t s_tmh[64 * 64];  // [v][y], v = frequency
  __shared__ int16_t s_tmw[64 * 64];  // [u][x]
  __shared__ int16_t s_dq[64 * 64];   // [v][u]
  __shared__ int32_t s_s0[64 * 64];   // [y][u]

  const int32_t* tu = tus + (size_t)blockIdx.x * 7;
  const int comp = tu[0], lw = tu[1], lh = tu[2];
  const long long scale = tu[3];
  const int ty = tu[4], tx = tu[5], trs = tu[6];
  const bool main_tx = iqt || trs;
  const int w = 1 << lw, h = 1 << lh, n = w * h;
  const long long g = batch_of(tu_off, G, blockIdx.x);
  const int16_t* coef = comp == 0 ? coef_y + g * cbs_y
                                  : (comp == 1 ? coef_u : coef_v) + g * cbs_c;
  int16_t* res = comp == 0 ? res_y + g * rbs_y
                           : (comp == 1 ? res_u : res_v) + g * rbs_c;
  const int cs = comp ? cs_c : cs_y;
  const int rs = comp ? rs_c : rs_y;

  const int odd = (lw + lh) & 1;
  const int log2_size = (lw + lh) >> 1;
  const int tr_shift = 15 - bd - log2_size;  // MAX_TX_DYNAMIC_RANGE
  const int shift = 20 - 14 - tr_shift + (odd ? 8 : 0);
  const long long offset = shift == 0 ? 0 : (1LL << (shift - 1));
  const long long m = scale * (odd ? 181 : 1);

  load_basis(s_tmh, lh, trs ? (trs & 3) - 1 : -1, tm64, tr);
  load_basis(s_tmw, lw, trs ? (trs >> 2) - 1 : -1, tm64, tr);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int v = i >> lw, u = i & (w - 1);
    const long long c = coef[(size_t)(ty + v) * cs + tx + u];
    s_dq[i] = (int16_t)clamp64((c * m + offset) >> shift, -32768, 32767);
  }
  __syncthreads();

  // stage 0: s0[y][u] = sum_v TMh[v][y] * dq[v][u]
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int y = i >> lw, u = i & (w - 1);
    long long acc = 0;
    for (int v = 0; v < h; ++v)
      acc += (long long)s_tmh[v * h + y] * s_dq[v * w + u];
    s_s0[i] = (int32_t)(main_tx ? clamp64((acc + 64) >> 7, -32768, 32767)
                                : clamp64(acc, -2147483647LL, 2147483647LL));
  }
  __syncthreads();

  // stage 1: r[y][x] = (sum_u s0[y][u] * TMw[u][x] + add) >> shift2
  const int shift2 = main_tx ? 20 - bd : 7 + 12 - (bd - 8);
  const long long add = 1LL << (shift2 - 1);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int y = i >> lw, x = i & (w - 1);
    long long acc = 0;
    for (int u = 0; u < w; ++u)
      acc += (long long)s_s0[y * w + u] * s_tmw[u * w + x];
    acc = clamp64((acc + add) >> shift2, MIN_TX_VAL, MAX_TX_VAL);
    res[(size_t)(BORDER + ty + y) * rs + BORDER + tx + x] = (int16_t)acc;
  }
}

}  // namespace

// tu_off: device int32 [G + 1], or NULL for one frame (G 1); cbs / rbs: the
// batch strides of the coefficient and residual planes, in elements.
extern "C" int xevd_itdq(const void* coef_y, const void* coef_u,
                         const void* coef_v, int cs_y, int cs_c, void* res_y,
                         void* res_u, void* res_v, int rs_y, int rs_c,
                         const void* tus, int n_tus, const void* tm64,
                         const void* tr, int bd, int iqt, const void* tu_off,
                         int G, long long cbs_y, long long cbs_c,
                         long long rbs_y, long long rbs_c, void* stream) {
  if (n_tus > 0) {
    itdq_kernel<<<n_tus, ITDQ_THREADS, 0, (cudaStream_t)stream>>>(
        (const int16_t*)coef_y, (const int16_t*)coef_u,
        (const int16_t*)coef_v, cs_y, cs_c, (int16_t*)res_y, (int16_t*)res_u,
        (int16_t*)res_v, rs_y, rs_c, (const int32_t*)tus,
        (const int32_t*)tm64, (const int32_t*)tr, bd, iqt,
        (const int32_t*)tu_off, G, cbs_y, cbs_c, rbs_y, rbs_c);
  }
  return (int)cudaGetLastError();
}
