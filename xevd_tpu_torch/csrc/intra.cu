// Baseline intra reconstruction of a frame, one CU after another in decode
// order, in place on the bordered int16 picture planes.
//
// Replaces: xevd_tpu/ops/jax_intra.py `intra_scan` (K5; `_step_plane`,
// `_predict`), a lax.scan with one CU per step.  Semantics per CU and
// plane: up/left neighbours under per-unit availability masks (uint32
// bitfields, 4-px units for luma, 2-px for chroma, logical shifts), corner
// under its flag, unavailable samples = 1 << (bd - 1); the five Baseline
// predictors DC/HOR/VER/UL/UR (ref: src_base/xevd_ipred.c:95-676);
// pred + residual wrapped through int16, clipped to [0, 2^bd - 1], written
// over the cuw x cuw block.  Chroma uses the luma ipm with log2 - 1.
//
// Bound on the H100: latency.  CU n reads samples that CUs < n wrote, so
// the CU loop is strictly sequential; each step is a few hundred bytes of
// neighbours and at most 64x64 outputs.  The time is the chain of
// per-CU barriers and global-memory round trips, not bandwidth or ALU.
//
// Design: one launch per frame, one CTA of 1024 threads that walks the CU
// table.  Per CU and plane: stage neighbours in shared memory, reduce the
// DC sum with shared atomics, predict and write the block with a strided
// loop, then __syncthreads() so the next CU sees the written samples
// (global writes of a block are visible to the block after the barrier).
// Running independent CUs concurrently (a wavefront, as K6 does for Main)
// is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#define BORDER 72
#define INTRA_THREADS 1024

namespace {

__device__ void cu_plane(int16_t* rec, const int16_t* res, int stride, int x,
                         int y, int log2, int ipm, uint32_t up_mask,
                         uint32_t left_mask, int corner_f, int unit, int bd,
                         int* s_up, int* s_left, int* s_corner, int* s_sum) {
  const int t = threadIdx.x;
  const int cuw = 1 << log2, n2 = 2 * cuw;
  const int mid = 1 << (bd - 1), maxv = (1 << bd) - 1;
  int16_t* base = rec + (long)(BORDER + y) * stride + BORDER + x;
  const int16_t* rbase = res + (long)(BORDER + y) * stride + BORDER + x;

  if (t < n2) {
    const uint32_t u = (uint32_t)(t / unit);
    s_up[t] = ((up_mask >> u) & 1u) ? (int)base[t - stride] : mid;
    s_left[t] = ((left_mask >> u) & 1u) ? (int)base[(long)t * stride - 1]
                                         : mid;
  }
  if (t == 0) {
    *s_corner = corner_f == 1 ? (int)base[-stride - 1] : mid;
    *s_sum = 0;
  }
  __syncthreads();
  if (ipm == 0 && t < cuw) atomicAdd(s_sum, s_up[t] + s_left[t]);
  __syncthreads();
  const int dc = (*s_sum + cuw) >> (log2 + 1);
  const int corner = *s_corner;

  for (int i = t; i < cuw * cuw; i += blockDim.x) {
    const int ii = i >> log2, jj = i & (cuw - 1);
    int pred;
    if (ipm == 2) {
      pred = s_up[jj];                                   // VER
    } else if (ipm == 1) {
      pred = s_left[ii];                                 // HOR
    } else if (ipm == 0) {
      pred = dc;                                         // DC
    } else if (ipm == 3) {                               // UL
      const int d = ii - jj;
      pred = d > 0 ? s_left[d - 1] : (d == 0 ? corner : s_up[-d - 1]);
    } else {                                             // UR
      const int k = ii + jj + 1;
      pred = (s_up[k] + s_left[k]) >> 1;
    }
    int v = (int16_t)(pred + (int)rbase[(long)ii * stride + jj]);
    v = v < 0 ? 0 : (v > maxv ? maxv : v);
    base[(long)ii * stride + jj] = (int16_t)v;
  }
  __syncthreads();
}

// CU row: x, y, log2, ipm, up_mask, left_mask, corner, valid
__global__ void __launch_bounds__(INTRA_THREADS)
intra_scan_kernel(int16_t* rec_y, int16_t* rec_u, int16_t* rec_v,
                  const int16_t* res_y, const int16_t* res_u,
                  const int16_t* res_v, int stride_y, int stride_c,
                  const int32_t* __restrict__ icu, int n_cu, int bd,
                  int chroma) {
  __shared__ int s_up[128], s_left[128], s_corner, s_sum;
  for (int n = 0; n < n_cu; ++n) {
    const int32_t* c = icu + (size_t)n * 8;
    if (c[7] != 1) continue;  // block-uniform: every thread reads the row
    const int x = c[0], y = c[1], log2 = c[2], ipm = c[3];
    const uint32_t upm = (uint32_t)c[4], lem = (uint32_t)c[5];
    const int cor = c[6];
    cu_plane(rec_y, res_y, stride_y, x, y, log2, ipm, upm, lem, cor, 4, bd,
             s_up, s_left, &s_corner, &s_sum);
    if (chroma) {
      cu_plane(rec_u, res_u, stride_c, x >> 1, y >> 1, log2 - 1, ipm, upm,
               lem, cor, 2, bd, s_up, s_left, &s_corner, &s_sum);
      cu_plane(rec_v, res_v, stride_c, x >> 1, y >> 1, log2 - 1, ipm, upm,
               lem, cor, 2, bd, s_up, s_left, &s_corner, &s_sum);
    }
  }
}

}  // namespace

extern "C" int xevd_intra_scan(void* rec_y, void* rec_u, void* rec_v,
                               const void* res_y, const void* res_u,
                               const void* res_v, int stride_y, int stride_c,
                               const void* icu, int n_cu, int bd, int chroma,
                               void* stream) {
  if (n_cu > 0) {
    intra_scan_kernel<<<1, INTRA_THREADS, 0, (cudaStream_t)stream>>>(
        (int16_t*)rec_y, (int16_t*)rec_u, (int16_t*)rec_v,
        (const int16_t*)res_y, (const int16_t*)res_u, (const int16_t*)res_v,
        stride_y, stride_c, (const int32_t*)icu, n_cu, bd, chroma);
  }
  return (int)cudaGetLastError();
}
