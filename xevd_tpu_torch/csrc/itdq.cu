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
// Bound on the H100: neither bytes nor operations.  A 1080p frame needs
// about 100 M multiply-adds, a few us of the SMs' int32 rate, and moves
// about 8 MB.  What costs is the shape of the work: tens of thousands of
// TUs, most of them 4x4 to 8x8.
//
// Design: one launch a frame (or GOP step) over the TUs grouped by size
// class (log2 w, log2 h, Main or Baseline).  The host sorts the TU rows by
// class with a counting sort (ops/pack.py `itdq_order`; `tus` keeps its
// order): `order` lists (TU row, frame g) class by class, and `classes`
// gives each class its first CTA, first order entry, TU count and shape,
// (main << 16) | (log2 R << 12) | (log2 T << 8) | (log2 w << 4) | log2 h.
// A class's CTA runs 256 / T TUs of T threads each, T = clamp(n / 4, 16,
// 256) for n = w h samples: sixteen 4x4 or 8x8 TUs, four 16x16, one 32x32
// a CTA; a TU of more than 1,024 samples takes R = n / 1,024 CTAs, each
// h / R of its stage-0 and residual rows (a 64x64 TU four CTAs of 16
// rows), so no single CTA is the launch's long pole.  A thread's work item
// in each stage is a quad, four consecutive outputs along the basis'
// sample axis (two for a side of 2): one 16-byte load of a basis row
// serves four multiply-adds, and the other operand is read once for them;
// every thread has at most one quad a stage, and the sums run over a
// size fixed at compile time (one instance a size).  Each TU stages its
// dequantized block (int16, 2 n bytes) and its rows' stage-0 result
// (int32, 4 n / R bytes) in shared memory; the launch's dynamic shared
// memory is its largest class's, at most 12 KB -- never the occupancy
// limit.  The bases are read from the read-only tables (L1): in stage 0 a
// warp's lanes share the basis row and read adjacent coefficients; in
// stage 1 they share the stage-0 sample and read adjacent basis quads;
// coefficient reads and residual row writes are adjacent across lanes.
//
// Integer widths: no DCT-2 or ATS basis column sums to more than 3,707 in
// absolute value (tests/test_torch_itdq.py computes it from the tables), so
// stage 0 on int16 input stays below 32,768 x 3,707 = 1.22e8 < 2^31, and so
// does Main stage 1, whose input is clipped to int16: both are plain int32
// multiply-adds (the Baseline stage-0 clip to +-(2^31 - 1) is kept and is a
// no-op).  Baseline stage 1 can reach 4.5e11: its int32 stage-0 input is
// split into the halves s = hi * 2^16 + lo (0 <= lo < 2^16, |hi| < 1,850),
// each summed in int32 (< 2.5e8) and combined in int64 once an output.
// The dequant is int64 once a sample (scale x 181 x 32,768 overflows int32).
//
// GOP batch (K15): the TU table holds the TUs of the G frames of one time
// step; each order entry carries its frame g, whose planes lie g times each
// plane's batch stride from the first.  Still one launch a step.
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

__device__ __forceinline__ int clamp32(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Column j of the n-point basis of one axis: entry k at b[k * pitch];
// kind -1 the DCT-2 from the 64-point basis (TMn[k][j] = TM64[k << (6 -
// lg)][j]), 0 the DST-7, 1 the DCT-8 ([2][6][32][32], lg <= 5).
__device__ __forceinline__ const int32_t* basis_col(
    int lg, int kind, int j, const int32_t* __restrict__ tm64,
    const int32_t* __restrict__ tr, int& pitch) {
  if (kind < 0) {
    pitch = 64 << (6 - lg);
    return tm64 + j;
  }
  pitch = 32;
  return tr + (kind * 6 + lg) * 32 * 32 + j;
}

// Q consecutive int32 basis entries (16- or 8-byte aligned: Q | j)
template <int Q>
__device__ __forceinline__ void load_q(const int32_t* p, int* t) {
  if (Q == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    t[0] = v.x;
    t[1] = v.y;
    t[2] = v.z;
    t[3] = v.w;
  } else {
    const int2 v = __ldg(reinterpret_cast<const int2*>(p));
    t[0] = v.x;
    t[1] = v.y;
  }
}

// Stage 0 of the 2^lhr rows from y_base of one TU of height 2^L into
// s_s0 (its rows from 0): each work item is Q consecutive rows y0 .. y0 +
// Q - 1 at one column u, so one vector load of the basis row serves Q
// multiply-adds and the dequantized sample is read once for them.  L is a
// template argument, so the sum over v has a fixed trip count.
template <int L>
__device__ __forceinline__ void stage0(const int16_t* s_dq, int32_t* s_s0,
                                       int lw, int lhr, int y_base,
                                       int kind,
                                       const int32_t* __restrict__ tm64,
                                       const int32_t* __restrict__ tr,
                                       bool main_cls, int i0, int T) {
  constexpr int H = 1 << L, Q = L == 1 ? 2 : 4;
  const int w = 1 << lw, nq = ((1 << lhr) / Q) << lw;
  for (int q = i0; q < nq; q += T) {
    const int u = q & (w - 1), y0 = (q >> lw) * Q;
    int pitch;
    const int32_t* b = basis_col(L, kind, y_base + y0, tm64, tr, pitch);
    int acc[Q] = {};
#pragma unroll 8
    for (int v = 0; v < H; ++v) {
      int t[Q];
      load_q<Q>(b + v * pitch, t);
      const int d = s_dq[v * w + u];
#pragma unroll
      for (int k = 0; k < Q; ++k) acc[k] += t[k] * d;
    }
#pragma unroll
    for (int k = 0; k < Q; ++k)
      s_s0[(y0 + k) * w + u] =
          main_cls ? clamp32((acc[k] + 64) >> 7, -32768, 32767)
                   : max(acc[k], -2147483647);  // the +-(2^31-1) clip
  }
}

// Stage 1 of 2^lhr rows of one TU of width 2^L (s_s0's) into its residual
// rows r0[y * rs + x]: each work item is Q consecutive columns x0 .. x0 +
// Q - 1 of one row y.  MAIN: int32 sums of the int16 input; Baseline: the
// input's halves s = hi * 2^16 + lo summed apart in int32 and combined in
// int64.
template <int L, bool MAIN>
__device__ __forceinline__ void stage1(const int32_t* s_s0, int16_t* r0,
                                       int rs, int lhr, int kind,
                                       const int32_t* __restrict__ tm64,
                                       const int32_t* __restrict__ tr,
                                       int shift2, int i0, int T) {
  constexpr int W = 1 << L, Q = L == 1 ? 2 : 4, LQ = L == 1 ? 0 : L - 2;
  const int nq = (1 << lhr) << LQ;
  const long long add = 1LL << (shift2 - 1);
  for (int q = i0; q < nq; q += T) {
    const int y = q >> LQ, x0 = (q & ((1 << LQ) - 1)) * Q;
    int pitch;
    const int32_t* b = basis_col(L, kind, x0, tm64, tr, pitch);
    const int32_t* s0 = s_s0 + y * W;
    int a_lo[Q] = {}, a_hi[Q] = {};
#pragma unroll 8
    for (int u = 0; u < W; ++u) {
      int t[Q];
      load_q<Q>(b + u * pitch, t);
      const int s = s0[u];
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        if (MAIN) {
          a_lo[k] += s * t[k];
        } else {
          a_lo[k] += (s & 0xffff) * t[k];
          a_hi[k] += (s >> 16) * t[k];
        }
      }
    }
    int16_t* out = r0 + (size_t)y * rs + x0;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const long long acc = MAIN ? (long long)a_lo[k]
                                 : ((long long)a_hi[k] << 16) + a_lo[k];
      out[k] = (int16_t)clamp64((acc + add) >> shift2, MIN_TX_VAL,
                                MAX_TX_VAL);
    }
  }
}

#define ITDQ_SIZES(F) F(1) F(2) F(3) F(4) F(5) F(6)

// TU row: comp, log2w, log2h, scale, y, x, trs
__global__ void __launch_bounds__(ITDQ_THREADS)
itdq_kernel(const int16_t* __restrict__ coef_y,
            const int16_t* __restrict__ coef_u,
            const int16_t* __restrict__ coef_v, int cs_y, int cs_c,
            int16_t* __restrict__ res_y, int16_t* __restrict__ res_u,
            int16_t* __restrict__ res_v, int rs_y, int rs_c,
            const int32_t* __restrict__ tus,
            const int32_t* __restrict__ order,
            const int32_t* __restrict__ classes, int n_cls,
            const int32_t* __restrict__ tm64,
            const int32_t* __restrict__ tr, int bd, long long cbs_y,
            long long cbs_c, long long rbs_y, long long rbs_c) {
  extern __shared__ __align__(16) unsigned char q_smem[];
  // this CTA's class: the last with first CTA <= blockIdx.x
  int lo = 0, hi = n_cls - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (classes[mid * 4] <= (int)blockIdx.x)
      lo = mid;
    else
      hi = mid - 1;
  }
  // (the tables are views into the frame's int32 payload: 4-byte aligned)
  const int cta0 = classes[lo * 4], ord0 = classes[lo * 4 + 1];
  const int count = classes[lo * 4 + 2], shape = classes[lo * 4 + 3];
  const int lw = (shape >> 4) & 15, lh = shape & 15, lt = (shape >> 8) & 15;
  const int lr = (shape >> 12) & 15;             // log2 CTAs a TU
  const bool main_cls = (shape >> 16) & 1;
  const int w = 1 << lw, n = 1 << (lw + lh), T = 1 << lt;
  const int P = ITDQ_THREADS >> lt;              // TUs a CTA
  const int slot = threadIdx.x >> lt, i0 = threadIdx.x & (T - 1);
  const int b = (int)blockIdx.x - cta0;
  const int j = (b >> lr) * P + slot;            // the TU in its class
  const int lhr = lh - lr;                       // log2 rows this CTA owns
  const int y_base = (b & ((1 << lr) - 1)) << lhr;
  const bool active = j < count;
  int16_t* s_dq = reinterpret_cast<int16_t*>(q_smem) + slot * n;
  int32_t* s_s0 = reinterpret_cast<int32_t*>(q_smem + P * n * 2) +
                  (slot * n >> lr);

  int comp = 0, ty = 0, tx = 0, trs = 0;
  long long scale = 0, g = 0;
  if (active) {
    const int32_t* og = order + (size_t)(ord0 + j) * 2;
    const int32_t* tu = tus + (size_t)og[0] * 7;
    comp = tu[0];
    scale = tu[3];
    ty = tu[4];
    tx = tu[5];
    trs = tu[6];
    g = og[1];
  }
  const int16_t* coef = comp == 0 ? coef_y + g * cbs_y
                                  : (comp == 1 ? coef_u : coef_v) + g * cbs_c;
  int16_t* res = comp == 0 ? res_y + g * rbs_y
                           : (comp == 1 ? res_u : res_v) + g * rbs_c;
  const int cs = comp ? cs_c : cs_y;
  const int rs = comp ? rs_c : rs_y;

  // dequant, int64 once a sample, into shared memory [v][u]
  if (active) {
    const int odd = (lw + lh) & 1;
    const int log2_size = (lw + lh) >> 1;
    const int tr_shift = 15 - bd - log2_size;  // MAX_TX_DYNAMIC_RANGE
    const int shift = 20 - 14 - tr_shift + (odd ? 8 : 0);
    const long long offset = shift == 0 ? 0 : (1LL << (shift - 1));
    const long long m = scale * (odd ? 181 : 1);
#pragma unroll 4
    for (int i = i0; i < n; i += T) {
      const int v = i >> lw, u = i & (w - 1);
      const long long c = coef[(size_t)(ty + v) * cs + tx + u];
      s_dq[i] = (int16_t)clamp64((c * m + offset) >> shift, -32768, 32767);
    }
  }
  __syncthreads();

  // stage 0: s0[y][u] = sum_v TMh[v][y] * dq[v][u], int32
  if (active) {
    const int kind = trs ? (trs & 3) - 1 : -1;
    switch (lh) {
#define STAGE0(L)                                                          \
  case L:                                                                  \
    stage0<L>(s_dq, s_s0, lw, lhr, y_base, kind, tm64, tr, main_cls, i0, T); \
    break;
      ITDQ_SIZES(STAGE0)
#undef STAGE0
    }
  }
  __syncthreads();

  // stage 1: r[y][x] = (sum_u s0[y][u] * TMw[u][x] + add) >> shift2
  if (active) {
    const int kind = trs ? (trs >> 2) - 1 : -1;
    const int shift2 = main_cls ? 20 - bd : 7 + 12 - (bd - 8);
    int16_t* r0 = res + (size_t)(BORDER + ty + y_base) * rs + BORDER + tx;
    switch (lw + 8 * main_cls) {
#define STAGE1(L)                                                         \
  case L:                                                                 \
    stage1<L, false>(s_s0, r0, rs, lhr, kind, tm64, tr, shift2, i0, T);   \
    break;                                                                \
  case L + 8:                                                             \
    stage1<L, true>(s_s0, r0, rs, lhr, kind, tm64, tr, shift2, i0, T);    \
    break;
      ITDQ_SIZES(STAGE1)
#undef STAGE1
    }
  }
}

}  // namespace

// order: device int32 [N, 2] (TU row, frame g) by class; classes: device
// int32 [n_cls, 4] (first CTA, first order entry, TUs, shape); n_cta CTAs
// of smem bytes of dynamic shared memory (ops/pack.py `itdq_order`);
// cbs / rbs: the batch strides of the coefficient and residual planes, in
// elements (0 for one frame).
extern "C" int xevd_itdq(const void* coef_y, const void* coef_u,
                         const void* coef_v, int cs_y, int cs_c, void* res_y,
                         void* res_u, void* res_v, int rs_y, int rs_c,
                         const void* tus, const void* order,
                         const void* classes, int n_cls, int n_cta, int smem,
                         const void* tm64, const void* tr, int bd,
                         long long cbs_y, long long cbs_c, long long rbs_y,
                         long long rbs_c, void* stream) {
  if (smem > (48 << 10)) return (int)cudaErrorInvalidValue;
  if (n_cta > 0 && n_cls > 0) {
    itdq_kernel<<<n_cta, ITDQ_THREADS, smem, (cudaStream_t)stream>>>(
        (const int16_t*)coef_y, (const int16_t*)coef_u,
        (const int16_t*)coef_v, cs_y, cs_c, (int16_t*)res_y, (int16_t*)res_u,
        (int16_t*)res_v, rs_y, rs_c, (const int32_t*)tus,
        (const int32_t*)order, (const int32_t*)classes, n_cls,
        (const int32_t*)tm64, (const int32_t*)tr, bd, cbs_y, cbs_c, rbs_y,
        rbs_c);
  }
  return (int)cudaGetLastError();
}
