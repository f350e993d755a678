// ADDB, the Main profile's advanced deblocking: four passes, in place on the
// H8 x W8 picture area.
//
// Replaces: xevd_tpu/ops/jax_deblock.py `addb_luma_ver`, `addb_luma_hor`,
// `addb_chroma_ver`, `addb_chroma_hor` (K11; line filters
// xevd_tpu/ops/addb_common.py `luma_line` :21, `chroma_line` :87; ref:
// src_main/xevdm_df.c:550-781).  The function that runs them in reference
// order (luma ver, chroma ver U and V, luma hor, chroma hor U and V) is
// xevd_tpu_torch/ops/addb.py `addb_frame` (K12 `_deblock_finish_addb`).
//
// Bound on the H100: memory.  A pass reads at most 8 samples and writes 6
// per edge line on a grid of one edge per 8 (luma) or 4 (chroma) samples,
// with some 60 integer operations per line; there is no reuse.
//
// Design: one thread per (line, edge).  Each thread reads its per-SCU
// parameters (bs, alpha, beta, c) straight from the map the JAX version
// repeats: pars[r >> 2][2 e] for a luma vertical edge, pars[2 e][c >> 2]
// for a horizontal one (>> 1 for chroma); channel 0 is bs, channels cb,
// cb + 1, cb + 2 alpha, beta and c (chroma U: cb 1, V: cb 4).
//
// In place without a race: the JAX version filters every edge of a pass
// from the pass's input.  A luma edge at x = 8 e reads x - 4 .. x + 3 and
// writes x - 3 .. x + 2; the next edge reads from x + 4 and writes from
// x + 5.  A chroma edge at x = 4 e reads x - 2 .. x + 1 and writes x - 1,
// x; the next reads from x + 2.  So no edge reads a sample another edge of
// its pass writes, and the in-place result equals the JAX one.
#include <cuda_runtime.h>
#include <stdint.h>

#define ADDB_THREADS 256

namespace {

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return min(max(v, lo), hi);  // addb_common._clip3: min(max(v, lo), hi)
}

__device__ __forceinline__ int iabs(int a) { return a < 0 ? -a : a; }

// p points at q0 (the first sample past the edge), `step` is the distance
// across the edge; P the edge's parameter cell.
__device__ __forceinline__ void luma_line(int16_t* p, long step,
                                          const int32_t* P, int cb, int bd) {
  const int bs = P[0], alpha = P[cb], beta = P[cb + 1], c1 = P[cb + 2];
  if (bs <= 0) return;
  const int p0 = p[-step], p1 = p[-2 * step], p2 = p[-3 * step],
            p3 = p[-4 * step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (!(iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta &&
        iabs(q1 - q0) < beta))
    return;
  const int maxv = (1 << bd) - 1;
  const bool ap = iabs(p0 - p2) < beta, aq = iabs(q0 - q2) < beta;
  int fp0, fp1, fp2, fq0, fq1, fq2;
  if (bs == 4) {  // strong filter (xevdm_df.c:633-651)
    const bool sthr = iabs(p0 - q0) < ((alpha >> 2) + 2);
    const bool p_on = ap && sthr, q_on = aq && sthr;
    fp0 = p_on ? (p2 + 2 * (p1 + p0 + q0) + q1 + 4) >> 3
               : (2 * p1 + p0 + q1 + 2) >> 2;
    fp1 = p_on ? (p2 + p1 + p0 + q0 + 2) >> 2 : p1;
    fp2 = p_on ? (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3 : p2;
    fq0 = q_on ? (q2 + 2 * (q1 + q0 + p0) + p1 + 4) >> 3
               : (2 * q1 + q0 + p1 + 2) >> 2;
    fq1 = q_on ? (q2 + q1 + q0 + p0 + 2) >> 2 : q1;
    fq2 = q_on ? (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3 : q2;
  } else {  // normal filter (:652-690)
    const int shift = bd > 9 ? bd - 9 : 0;
    const int c0 = c1 + (((int)ap + (int)aq) << shift);
    const int d0 = clip3(-c0, c0, (4 * (q0 - p0) + p1 - q1 + 4) >> 3);
    fp0 = clip3(0, maxv, p0 + d0);
    fq0 = clip3(0, maxv, q0 - d0);
    const int d1p = clip3(-c1, c1, ((p2 + p0 + q0) * 3 - 8 * p1 - q1) >> 4);
    const int d1q = clip3(-c1, c1, ((q2 + q0 + p0) * 3 - 8 * q1 - p1) >> 4);
    fp1 = ap ? p1 + d1p : p1;
    fq1 = aq ? q1 + d1q : q1;
    fp2 = p2;
    fq2 = q2;
  }
  // final clip of taps 0..2 (:691-699)
  p[-step] = (int16_t)clip3(0, maxv, fp0);
  p[-2 * step] = (int16_t)clip3(0, maxv, fp1);
  p[-3 * step] = (int16_t)clip3(0, maxv, fp2);
  p[0] = (int16_t)clip3(0, maxv, fq0);
  p[step] = (int16_t)clip3(0, maxv, fq1);
  p[2 * step] = (int16_t)clip3(0, maxv, fq2);
}

__device__ __forceinline__ void chroma_line(int16_t* p, long step,
                                            const int32_t* P, int cb, int bd) {
  const int bs = P[0], alpha = P[cb], beta = P[cb + 1], c0 = P[cb + 2];
  if (bs <= 0) return;
  const int p0 = p[-step], p1 = p[-2 * step], q0 = p[0], q1 = p[step];
  if (!(iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta &&
        iabs(q1 - q0) < beta))
    return;
  const int maxv = (1 << bd) - 1;
  int fp0, fq0;
  if (bs == 4) {  // (xevdm_df.c:710-781)
    fp0 = (2 * p1 + p0 + q1 + 2) >> 2;
    fq0 = (2 * q1 + q0 + p1 + 2) >> 2;
  } else {
    const int d0 = clip3(-c0, c0, (4 * (q0 - p0) + p1 - q1 + 4) >> 3);
    fp0 = clip3(0, maxv, p0 + d0);
    fq0 = clip3(0, maxv, q0 - d0);
  }
  p[-step] = (int16_t)clip3(0, maxv, fp0);
  p[0] = (int16_t)clip3(0, maxv, fq0);
}

// area [H, W] with row pitch `stride`; pars [H/4, W/4, nch] (luma) or
// [H/2, W/2, nch] (chroma).  Vertical passes: thread per (row, edge e >= 1),
// horizontal passes: thread per (edge e >= 1, column).
__global__ void luma_ver_kernel(int16_t* area, int stride, int H, int W,
                                const int32_t* __restrict__ pars, int nch,
                                int cb, int bd) {
  const int ne = (W >> 3) - 1, ws = W >> 2;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (ne <= 0 || idx >= (long)H * ne) return;
  const int r = (int)(idx / ne), e = (int)(idx % ne) + 1;
  luma_line(area + (long)r * stride + 8 * e, 1,
            pars + ((long)(r >> 2) * ws + 2 * e) * nch, cb, bd);
}

__global__ void luma_hor_kernel(int16_t* area, int stride, int H, int W,
                                const int32_t* __restrict__ pars, int nch,
                                int cb, int bd) {
  const int ne = (H >> 3) - 1, ws = W >> 2;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (ne <= 0 || idx >= (long)ne * W) return;
  const int e = (int)(idx / W) + 1, c = (int)(idx % W);
  luma_line(area + (long)(8 * e) * stride + c, stride,
            pars + ((long)(2 * e) * ws + (c >> 2)) * nch, cb, bd);
}

__global__ void chroma_ver_kernel(int16_t* area, int stride, int H, int W,
                                  const int32_t* __restrict__ pars, int nch,
                                  int cb, int bd) {
  const int ne = (W >> 2) - 1, ws = W >> 1;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (ne <= 0 || idx >= (long)H * ne) return;
  const int r = (int)(idx / ne), e = (int)(idx % ne) + 1;
  chroma_line(area + (long)r * stride + 4 * e, 1,
              pars + ((long)(r >> 1) * ws + 2 * e) * nch, cb, bd);
}

__global__ void chroma_hor_kernel(int16_t* area, int stride, int H, int W,
                                  const int32_t* __restrict__ pars, int nch,
                                  int cb, int bd) {
  const int ne = (H >> 2) - 1, ws = W >> 1;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (ne <= 0 || idx >= (long)ne * W) return;
  const int e = (int)(idx / W) + 1, c = (int)(idx % W);
  chroma_line(area + (long)(4 * e) * stride + c, stride,
              pars + ((long)(2 * e) * ws + (c >> 1)) * nch, cb, bd);
}

inline int blocks(long n) {
  return (int)((n + ADDB_THREADS - 1) / ADDB_THREADS);
}

}  // namespace

#define ADDB_ENTRY(NAME, KERNEL, LINES)                                     \
  extern "C" int NAME(void* area, int stride, int H, int W, const void* pars, \
                      int nch, int cb, int bd, void* stream) {              \
    const long n = (LINES);                                                 \
    if (n > 0)                                                              \
      KERNEL<<<blocks(n), ADDB_THREADS, 0, (cudaStream_t)stream>>>(         \
          (int16_t*)area, stride, H, W, (const int32_t*)pars, nch, cb, bd); \
    return (int)cudaGetLastError();                                         \
  }

ADDB_ENTRY(xevd_addb_luma_ver, luma_ver_kernel, (long)H * ((W >> 3) - 1))
ADDB_ENTRY(xevd_addb_luma_hor, luma_hor_kernel, (long)((H >> 3) - 1) * W)
ADDB_ENTRY(xevd_addb_chroma_ver, chroma_ver_kernel, (long)H * ((W >> 2) - 1))
ADDB_ENTRY(xevd_addb_chroma_hor, chroma_hor_kernel, (long)((H >> 2) - 1) * W)
