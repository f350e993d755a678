// Dequant + inverse DCT-2 of every transform unit of a frame, written into
// the bordered int16 residual planes.
//
// Replaces: xevd_tpu/ops/jax_itdq.py `itdq_bucket` (K1, Baseline variant)
// fused with xevd_tpu/ops/pipeline.py `_itdq_all` (K2: coefficient gather
// and residual scatter).  Arithmetic follows xevd_tpu/ops/ref_numpy.py
// `itdq_block` exactly: int64 dequant, stage 0 clipped to +-(2^31-1),
// stage 1 with the combined shift, clipped to [MIN_TX_VAL, MAX_TX_VAL].
//
// Bound on the H100: integer multiply-adds.  A 64x64 TU needs 2 * 64^3
// MACs; the coefficients and residuals are 4 bytes a sample, read and
// written once.  The JAX version split every wide product into 12- and
// 16-bit halves because the TPU has no fast int64; here the products are
// plain 64-bit integer arithmetic (emulated by the SM, but exact).
//
// Design: one launch per frame over the TU table; one CTA per TU, so TUs
// of every size share the launch (no per-size buckets).  The CTA stages the
// two n-point bases (taken from the 64-point basis: TMn[k][j] =
// TM64[k << (6 - log2 n)][j]), the dequantized block and the stage-0 result
// in shared memory (40 KB at 64x64), then each thread computes its outputs
// of each stage with a strided loop.  Small TUs leave most threads idle;
// packing several small TUs per CTA is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#define BORDER 72
#define MIN_TX_VAL (-32768)
#define MAX_TX_VAL 32767
#define ITDQ_THREADS 256

namespace {

__device__ __forceinline__ long long clamp64(long long v, long long lo,
                                             long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// TU row: comp, log2w, log2h, scale, y, x
__global__ void __launch_bounds__(ITDQ_THREADS)
itdq_kernel(const int16_t* __restrict__ coef_y,
            const int16_t* __restrict__ coef_u,
            const int16_t* __restrict__ coef_v, int cs_y, int cs_c,
            int16_t* __restrict__ res_y, int16_t* __restrict__ res_u,
            int16_t* __restrict__ res_v, int rs_y, int rs_c,
            const int32_t* __restrict__ tus,
            const int32_t* __restrict__ tm64, int bd) {
  __shared__ int16_t s_tmh[64 * 64];  // [v][y], v = frequency
  __shared__ int16_t s_tmw[64 * 64];  // [u][x]
  __shared__ int16_t s_dq[64 * 64];   // [v][u]
  __shared__ int32_t s_s0[64 * 64];   // [y][u]

  const int32_t* tu = tus + (size_t)blockIdx.x * 6;
  const int comp = tu[0], lw = tu[1], lh = tu[2];
  const long long scale = tu[3];
  const int ty = tu[4], tx = tu[5];
  const int w = 1 << lw, h = 1 << lh, n = w * h;
  const int16_t* coef = comp == 0 ? coef_y : (comp == 1 ? coef_u : coef_v);
  int16_t* res = comp == 0 ? res_y : (comp == 1 ? res_u : res_v);
  const int cs = comp ? cs_c : cs_y;
  const int rs = comp ? rs_c : rs_y;

  const int odd = (lw + lh) & 1;
  const int log2_size = (lw + lh) >> 1;
  const int tr_shift = 15 - bd - log2_size;  // MAX_TX_DYNAMIC_RANGE
  const int shift = 20 - 14 - tr_shift + (odd ? 8 : 0);
  const long long offset = shift == 0 ? 0 : (1LL << (shift - 1));
  const long long m = scale * (odd ? 181 : 1);

  for (int i = threadIdx.x; i < h * h; i += blockDim.x) {
    const int k = i >> lh, j = i & (h - 1);
    s_tmh[i] = (int16_t)tm64[(k << (6 - lh)) * 64 + j];
  }
  for (int i = threadIdx.x; i < w * w; i += blockDim.x) {
    const int k = i >> lw, j = i & (w - 1);
    s_tmw[i] = (int16_t)tm64[(k << (6 - lw)) * 64 + j];
  }
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
    s_s0[i] = (int32_t)clamp64(acc, -2147483647LL, 2147483647LL);
  }
  __syncthreads();

  // stage 1: r[y][x] = (sum_u s0[y][u] * TMw[u][x] + add) >> shift2
  const int shift2 = 7 + 12 - (bd - 8);
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

extern "C" int xevd_itdq(const void* coef_y, const void* coef_u,
                         const void* coef_v, int cs_y, int cs_c, void* res_y,
                         void* res_u, void* res_v, int rs_y, int rs_c,
                         const void* tus, int n_tus, const void* tm64, int bd,
                         void* stream) {
  if (n_tus > 0) {
    itdq_kernel<<<n_tus, ITDQ_THREADS, 0, (cudaStream_t)stream>>>(
        (const int16_t*)coef_y, (const int16_t*)coef_u,
        (const int16_t*)coef_v, cs_y, cs_c, (int16_t*)res_y, (int16_t*)res_u,
        (int16_t*)res_v, rs_y, rs_c, (const int32_t*)tus,
        (const int32_t*)tm64, bd);
  }
  return (int)cudaGetLastError();
}
