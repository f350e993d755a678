// ALF, the Main profile's adaptive loop filter: one CTA per CTU, luma and
// chroma.
//
// Replaces: xevd_tpu/ops/jax_alf.py `alf_apply` (K13) with `_fix_margins`
// (:32), `_classify` (:54), `_filter_luma` (:124) and `_filter_chroma`
// (:139); ref: src_main/xevdm_alf.c.  The stage runs after deblock and
// before pad (xevd_tpu/ops/pipeline.py:377-389, here ops/alf.py
// `alf_frame`).
//
// Bound on the H100: the work is small for the card -- a 1080p picture is
// 3 MB of samples read and written once, a few hundred integer operations
// per luma sample (classification and a 13-tap filter); neither term
// reaches 10 us.  What bounds this kernel is latency: about 510 CTAs (CTU
// 64) of three dependent phases each.
//
// Design: a CTA stages its CTU's (S + 6)^2 window of the PRE-ALF picture
// in shared memory (int16; 9.8 KB for S = 64, 35.9 KB for S = 128):
// replicate-extension by clamping to the picture, then `_fix_margins`'
// mirror rules at unavailable sides, columns first, and the side mirrors
// only on rows whose mapped row is a CTU interior row (:43-48).  Then one
// thread per 4x4 block classifies it into shared memory (the four
// Laplacians summed over the block's 8x8 neighbourhood), and one thread
// per sample applies the 7x7 diamond with coef[class][L_TBL[trans][i]].
// Every CTU reads the pre-ALF picture, so the wrapper hands the kernel a
// copy (src) and the kernel writes the area (dst): only samples inside
// the picture, and for luma only CTUs whose flag is set; chroma CTUs are
// all written, as the JAX chroma mask has no CTU flag (:222-224).
//
// The classifier's d1 * hv0 > hv1 * d0 wraps in 32 bits in the reference
// (and in JAX); signed overflow is undefined in C++, so the products are
// taken as uint32_t and compared cast back to int32_t.
#include <cuda_runtime.h>
#include <stdint.h>

#define ALF_THREADS 256
#define ALF_M 3

namespace {

__constant__ int ACT_TH[16] = {0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4};
__constant__ int TRANS_TBL[8] = {0, 1, 0, 2, 2, 3, 1, 3};
__constant__ int L_TBL[4][13] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12},
    {9, 4, 10, 8, 1, 5, 11, 7, 3, 0, 2, 6, 12},
    {0, 3, 2, 1, 8, 7, 6, 5, 4, 9, 10, 11, 12},
    {9, 8, 10, 4, 3, 7, 11, 5, 1, 0, 2, 6, 12}};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int iabs(int a) { return a < 0 ? -a : a; }

struct Ctu {
  int xs, ys, wb, hb, S, N;
  bool av_l, av_r, av_t, av_b;
};

// This CTA's CTU of a ph x pw plane, CTU size 2^log2_s (alf_apply
// :154-172, per plane: the chroma sizes are the luma ones >> 1).
__device__ Ctu ctu_of(int ph, int pw, int log2_s, int across) {
  Ctu c;
  c.S = 1 << log2_s;
  c.N = c.S + 2 * ALF_M;
  const int n_w = (pw + c.S - 1) >> log2_s;
  c.xs = (blockIdx.x % n_w) << log2_s;
  c.ys = (blockIdx.x / n_w) << log2_s;
  c.wb = min(c.S, pw - c.xs);
  c.hb = min(c.S, ph - c.ys);
  c.av_l = c.xs > 0;
  c.av_t = c.ys > 0;
  c.av_r = across || c.xs + c.wb != pw;
  c.av_b = across || c.ys + c.hb != ph;
  return c;
}

// Stage the CTU's window: window (rr, cc) -> `_fix_margins` -> the
// replicate-extended picture -> src.
__device__ void load_window(int16_t* win, const int16_t* __restrict__ src,
                            int sstride, int ph, int pw, const Ctu& c) {
  const int M = ALF_M, N = c.N;
  for (int idx = threadIdx.x; idx < N * N; idx += blockDim.x) {
    const int rr = idx / N, cc = idx - rr * N;
    int ccm = cc;
    if (!c.av_l && cc < M) ccm = 2 * M - cc;
    if (!c.av_r && cc >= M + c.wb) ccm = 2 * (M + c.wb) - ccm - 2;
    int rrm = rr;
    if (!c.av_t && rr < M) rrm = 2 * M - rr;
    if (!c.av_b && rr >= M + c.hb) rrm = 2 * (M + c.hb) - rrm - 2;
    if (!(rrm >= M && rrm < M + c.hb)) ccm = cc;
    rrm = clampi(rrm, 0, N - 1);
    ccm = clampi(ccm, 0, N - 1);
    const int y = clampi(c.ys + rrm - M, 0, ph - 1);
    const int x = clampi(c.xs + ccm - M, 0, pw - 1);
    win[idx] = src[(long)y * sstride + x];
  }
}

// (class << 2) | trans of the 4x4 block (bi, bj) (`_classify`): the
// vertical, horizontal and two diagonal Laplacians summed over window rows
// and columns M - 2 + 4 b .. M + 5 + 4 b.
__device__ int classify(const int16_t* win, int N, int bi, int bj, int bd) {
  int sv = 0, sh = 0, sd0 = 0, sd1 = 0;
  const int r0 = ALF_M - 2 + 4 * bi, c0 = ALF_M - 2 + 4 * bj;
  for (int r = r0; r < r0 + 8; ++r) {
    const int16_t* a = win + (r - 1) * N;
    const int16_t* b = win + r * N;
    const int16_t* d = win + (r + 1) * N;
    for (int x = c0; x < c0 + 8; ++x) {
      const int p2 = 2 * b[x];
      sv += iabs(p2 - a[x] - d[x]);
      sh += iabs(p2 - b[x - 1] - b[x + 1]);
      sd0 += iabs(p2 - a[x - 1] - d[x + 1]);
      sd1 += iabs(p2 - d[x - 1] - a[x + 1]);
    }
  }
  int cls = ACT_TH[clampi((sv + sh) >> (bd - 2), 0, 15)];
  const int hv1 = max(sv, sh), hv0 = min(sv, sh);
  const int dir_hv = sv > sh ? 1 : 3;
  const int d1 = max(sd0, sd1), d0 = min(sd0, sd1);
  const int dir_d = sd0 > sd1 ? 0 : 2;
  // the reference's wrapping int products (jax_alf.py:109-111)
  const bool use_d = (int32_t)((uint32_t)d1 * (uint32_t)hv0) >
                     (int32_t)((uint32_t)hv1 * (uint32_t)d0);
  const int hvd1 = use_d ? d1 : hv1, hvd0 = use_d ? d0 : hv0;
  const int main_dir = use_d ? dir_d : dir_hv;
  const int sec_dir = use_d ? dir_hv : dir_d;
  int ds = 0;
  if (hvd1 > 2 * hvd0) ds = 1;
  if (hvd1 * 2 > 9 * hvd0) ds = 2;
  if (ds > 0) cls += (((main_dir & 1) << 1) + ds) * 5;
  return (cls << 2) | TRANS_TBL[main_dir * 2 + (sec_dir >> 1)];
}

// sample (j + dy, i + dx) of the CTU, p pointing at (j, i) in the window
#define PX(dy, dx) ((int)p[(dy) * N + (dx)])

// src [ph, pw] (pitch sstride): the pre-ALF plane; dst: the area written.
__global__ void alf_luma_kernel(const int16_t* __restrict__ src, int sstride,
                                int16_t* dst, int dstride, int ph, int pw,
                                int log2_s, const int32_t* __restrict__ coef,
                                const int32_t* __restrict__ ctu_on,
                                int across, int bd) {
  if (ctu_on[blockIdx.x] <= 0) return;
  extern __shared__ int16_t win[];
  const Ctu c = ctu_of(ph, pw, log2_s, across);
  const int N = c.N;
  int* cls = (int*)(win + ((N * N + 1) & ~1));
  load_window(win, src, sstride, ph, pw, c);
  __syncthreads();
  const int nbw = (c.wb + 3) >> 2, nbh = (c.hb + 3) >> 2;
  for (int b = threadIdx.x; b < nbw * nbh; b += blockDim.x)
    cls[b] = classify(win, N, b / nbw, b % nbw, bd);
  __syncthreads();
  const int maxv = (1 << bd) - 1;
  for (int idx = threadIdx.x; idx < c.wb * c.hb; idx += blockDim.x) {
    const int j = idx / c.wb, i = idx - j * c.wb;
    const int cl = cls[(j >> 2) * nbw + (i >> 2)];
    const int32_t* cf = coef + (cl >> 2) * 13;
    const int* lt = L_TBL[cl & 3];
    const int16_t* p = win + (ALF_M + j) * N + ALF_M + i;
    const int acc =
        cf[lt[0]] * (PX(3, 0) + PX(-3, 0)) +
        cf[lt[1]] * (PX(2, 1) + PX(-2, -1)) +
        cf[lt[2]] * (PX(2, 0) + PX(-2, 0)) +
        cf[lt[3]] * (PX(2, -1) + PX(-2, 1)) +
        cf[lt[4]] * (PX(1, 2) + PX(-1, -2)) +
        cf[lt[5]] * (PX(1, 1) + PX(-1, -1)) +
        cf[lt[6]] * (PX(1, 0) + PX(-1, 0)) +
        cf[lt[7]] * (PX(1, -1) + PX(-1, 1)) +
        cf[lt[8]] * (PX(1, -2) + PX(-1, 2)) +
        cf[lt[9]] * (PX(0, 3) + PX(0, -3)) +
        cf[lt[10]] * (PX(0, 2) + PX(0, -2)) +
        cf[lt[11]] * (PX(0, 1) + PX(0, -1)) + cf[lt[12]] * PX(0, 0);
    dst[(long)(c.ys + j) * dstride + c.xs + i] =
        (int16_t)clampi((acc + 256) >> 9, 0, maxv);
  }
}

__global__ void alf_chroma_kernel(const int16_t* __restrict__ src,
                                  int sstride, int16_t* dst, int dstride,
                                  int ph, int pw, int log2_s,
                                  const int32_t* __restrict__ coef,
                                  int across, int bd) {
  extern __shared__ int16_t win[];
  const Ctu c = ctu_of(ph, pw, log2_s, across);
  const int N = c.N;
  load_window(win, src, sstride, ph, pw, c);
  __syncthreads();
  const int maxv = (1 << bd) - 1;
  for (int idx = threadIdx.x; idx < c.wb * c.hb; idx += blockDim.x) {
    const int j = idx / c.wb, i = idx - j * c.wb;
    const int16_t* p = win + (ALF_M + j) * N + ALF_M + i;
    const int acc =
        coef[0] * (PX(2, 0) + PX(-2, 0)) + coef[1] * (PX(1, 1) + PX(-1, -1)) +
        coef[2] * (PX(1, 0) + PX(-1, 0)) + coef[3] * (PX(1, -1) + PX(-1, 1)) +
        coef[4] * (PX(0, 2) + PX(0, -2)) + coef[5] * (PX(0, 1) + PX(0, -1)) +
        coef[6] * PX(0, 0);
    dst[(long)(c.ys + j) * dstride + c.xs + i] =
        (int16_t)clampi((acc + 256) >> 9, 0, maxv);
  }
}

#undef PX

inline int n_ctus(int ph, int pw, int log2_s) {
  const int S = 1 << log2_s;
  return ((ph + S - 1) >> log2_s) * ((pw + S - 1) >> log2_s);
}

// window int16 [N * N] (padded to 4 bytes), then (luma) int [(S/4)^2]
inline size_t smem_bytes(int log2_s, bool luma) {
  const int S = 1 << log2_s, N = S + 2 * ALF_M;
  return (size_t)((N * N + 1) & ~1) * sizeof(int16_t) +
         (luma ? (size_t)(S / 4) * (S / 4) * sizeof(int) : 0);
}

}  // namespace

extern "C" int xevd_alf_luma(const void* src, int sstride, void* dst,
                             int dstride, int ph, int pw, int log2_s,
                             const void* coef, const void* ctu_on, int across,
                             int bd, void* stream) {
  const int n = n_ctus(ph, pw, log2_s);
  if (n > 0)
    alf_luma_kernel<<<n, ALF_THREADS, smem_bytes(log2_s, true),
                      (cudaStream_t)stream>>>(
        (const int16_t*)src, sstride, (int16_t*)dst, dstride, ph, pw, log2_s,
        (const int32_t*)coef, (const int32_t*)ctu_on, across, bd);
  return (int)cudaGetLastError();
}

extern "C" int xevd_alf_chroma(const void* src, int sstride, void* dst,
                               int dstride, int ph, int pw, int log2_s,
                               const void* coef, const void* ctu_on,
                               int across, int bd, void* stream) {
  (void)ctu_on;  // chroma CTUs carry no flag
  const int n = n_ctus(ph, pw, log2_s);
  if (n > 0)
    alf_chroma_kernel<<<n, ALF_THREADS, smem_bytes(log2_s, false),
                        (cudaStream_t)stream>>>(
        (const int16_t*)src, sstride, (int16_t*)dst, dstride, ph, pw, log2_s,
        (const int32_t*)coef, across, bd);
  return (int)cudaGetLastError();
}
