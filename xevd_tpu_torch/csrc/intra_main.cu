// Main-profile (EIPD) intra reconstruction with HTDF over a wavefront level
// schedule, in place on the bordered int16 picture planes.
//
// Replaces: xevd_tpu/ops/jax_intra_main.py `intra_scan_wave` (K6: a
// lax.scan over dependency levels with `_pred_tile`, `_nbr_main`,
// `_fill_dir`, `_predict_main`, `_chroma_ipm_eff`, `_tile_idx_vals`,
// `_scatter_many`) and `_htdf_tile` (K7, with `_htdf_read_table`).
// Semantics per level: every CU of the level builds its up, left and right
// neighbour arrays with last-available fill (per-unit uint32 masks, 4-px
// units for luma, 2-px for chroma; unavailable before the first available
// unit = the corner or 1 << (bd - 1) for the up row, up[-1] for the left
// column, up[w] for the right column), predicts its one EIPD mode (DC,
// PLANE, BI, VER, HOR, angular, with the CU's left/right availability),
// adds its residual wrapped through int16, clips to [0, 2^bd - 1] and
// writes luma where its tree is not TREE_C (2) and chroma where it is not
// TREE_L (1); HTDF-only inter CUs (do_intra 0) write nothing here.  Then
// the level's HTDF CUs filter their luma from the planes after those
// writes: a (w + 2) x (h + 2) window with a 1-px ring gated by the
// availability bits (bottom row always replicated), 2x2 Hadamard windows,
// table shrink, inverse, the four overlapping windows summed.
//
// Bound on the H100: latency.  A level is a handful of CUs on average (the
// 1080p I picture of the smoke's Main stream: 6,289 CUs in 804 levels), so
// a level is a short dependent step: neighbour loads, a barrier, at most
// 64 x 64 outputs a CU.  The time is the chain of levels, not bandwidth or
// arithmetic.
//
// Design: the level loop lives in the C entry point and launches, per
// level, one kernel with one CTA per CU of the level (luma, then u and v,
// in the CTA), and, when the frame has HTDF, one kernel with one CTA per
// CU of the level that filters the HTDF CUs.  Launches on one stream run
// in order, so a level reads what the earlier levels wrote.  CUs of one
// level touch disjoint pixels and read only what earlier levels wrote (the
// host schedule, xevd_tpu/ops/wavefront.py), so the CTAs of a launch need
// no synchronisation between them.  Only a CU's own mode is evaluated (the
// JAX version evaluates all 33 on a tile and selects).  A CUDA graph or a
// persistent kernel over the levels is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#define BORDER 72
#define IM_THREADS 256
#define MAX_NBR 129  // w + h + 1 for a 64 x 64 CU

// offsets into the flat table (ops/tables.py INTRA_MAIN_PARTS)
#define T_DXDY 0
#define T_ADI 66
#define T_LUTP1 194
#define T_IBM 202
#define T_IBS 208
#define T_WC 214
#define T_HTDF 220
#define T_HTHR 300

// EIPD mode numbers (xevd_tpu/tables.py IPD_*)
#define IPD_DC 0
#define IPD_PLN 1
#define IPD_BI 2
#define IPD_VER 12
#define IPD_HOR 24
#define LR_01 2
#define LR_11 3

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Filled sample k of one neighbour direction: `raw(p)` reads sample p of
// the plane; unit u = k >> lg is available where bit u of `mask` is set.
template <typename Raw>
__device__ __forceinline__ int fill_at(int k, uint32_t mask, int lg, int seed,
                                       Raw raw) {
  const int u = k >> lg;
  const uint32_t upto = (u >= 31) ? 0xffffffffu : ((2u << u) - 1u);
  const uint32_t bits = mask & upto;
  if (bits == 0u) return seed;
  const int last = 31 - __clz(bits);
  return last == u ? raw(k) : raw((last << lg) + (1 << lg) - 1);
}

__device__ __forceinline__ int get_dc(int numer, int lw, int lh,
                                      const int32_t* tab) {
  const int asp = lw > lh ? lw - lh : lh - lw;
  return (numer * tab[T_LUTP1 + min(asp, 7)]) >> (min(lw, lh) + 12);
}

// One CU on one plane: neighbours, prediction, residual, write.  Every
// argument is uniform over the CTA.
__device__ void cu_plane(int16_t* rec, const int16_t* res, int stride, int x,
                         int y, int lw, int lh, int ipm, uint32_t um,
                         uint32_t lm, uint32_t rm, int co, int lr, int lg,
                         int bd, const int32_t* __restrict__ tab, int* s_up,
                         int* s_le, int* s_ri, int* s_par) {
  const int t = threadIdx.x;
  const int w = 1 << lw, h = 1 << lh, n = w + h;
  const int maxv = (1 << bd) - 1;
  int16_t* base = rec + (long)(BORDER + y) * stride + BORDER + x;
  const int16_t* rbase = res + (long)(BORDER + y) * stride + BORDER + x;
  const int corner_px = co == 1 ? (int)base[-stride - 1] : 0;

  // s_*[k + 1] = sample k, s_*[0] = position -1
  if (t < n) {
    s_up[t + 1] = fill_at(t, um, lg, co == 1 ? corner_px : 1 << (bd - 1),
                          [&](int p) { return (int)base[p - stride]; });
  }
  __syncthreads();
  const int up_m1 = co == 1 ? corner_px : s_up[1];
  const int ri_m1 = s_up[1 + w];
  if (t < n) {
    s_le[t + 1] = fill_at(t, lm, lg, up_m1, [&](int p) {
      return (int)base[(long)p * stride - 1];
    });
    s_ri[t + 1] = fill_at(t, rm, lg, ri_m1, [&](int p) {
      return (int)base[(long)p * stride + w];
    });
  }
  if (t == 0) {
    s_up[0] = up_m1;
    s_le[0] = up_m1;
    s_ri[0] = ri_m1;
  }
  __syncthreads();
  const int* up0 = s_up + 1;
  const int* le0 = s_le + 1;
  const int* ri0 = s_ri + 1;
  const bool right_av = (lr & 2) != 0;

  // the scalars of DC and PLANE: sums by the first warp
  if (t < 32 && (ipm == IPD_DC || ipm == IPD_PLN)) {
    const int w2 = w >> 1, h2 = h >> 1;
    int a = 0, b = 0, c = 0;
    if (ipm == IPD_DC) {
      for (int k = t; k < h; k += 32) { a += le0[k]; b += ri0[k]; }
      for (int k = t; k < w; k += 32) c += up0[k];
    } else {
      for (int k = t + 1; k <= w2; k += 32)
        a += right_av ? k * (s_up[1 + w2 - k] - s_up[1 + w2 + k])
                      : k * (s_up[w2 + k] - s_up[w2 - k]);
      for (int k = t + 1; k <= h2; k += 32)
        b += right_av ? k * (s_ri[h2 + k] - s_ri[h2 - k])
                      : k * (s_le[h2 + k] - s_le[h2 - k]);
    }
    a = warp_sum(a);
    b = warp_sum(b);
    c = warp_sum(c);
    if (t == 0) {
      if (ipm == IPD_DC) {
        s_par[0] = lr == LR_11
                       ? get_dc(a + b + c + ((w + h + h) >> 1), lw, lh + 1, tab)
                   : lr == LR_01 ? get_dc(b + c + ((w + h) >> 1), lw, lh, tab)
                                 : get_dc(a + c + ((w + h) >> 1), lw, lh, tab);
      } else {
        const int iw = lw > 2 ? lw - 2 : 0, ih = lh > 2 ? lh - 2 : 0;
        const int ibs_w = tab[T_IBS + iw], ibs_h = tab[T_IBS + ih];
        const int pb = ((a << 5) * tab[T_IBM + iw] + (1 << (ibs_w - 1))) >>
                       ibs_w;
        const int pc = ((b << 5) * tab[T_IBM + ih] + (1 << (ibs_h - 1))) >>
                       ibs_h;
        const int pa = right_av ? (ri0[h - 1] + up0[0]) << 4
                                : (le0[h - 1] + up0[w - 1]) << 4;
        s_par[0] = pa - (h2 - 1) * pc - (w2 - 1) * pb + 16;  // temp0
        s_par[1] = pb;
        s_par[2] = pc;
      }
    }
  }
  __syncthreads();

  const int lutp1 = tab[T_LUTP1 + lw];
  const int m0 = tab[T_DXDY + 2 * clampi(ipm, 0, 32)];
  const int m1 = tab[T_DXDY + 2 * clampi(ipm, 0, 32) + 1];
  for (int i = t; i < w * h; i += blockDim.x) {
    const int jj = i >> lw, ii = i & (w - 1);  // row, column
    int pred;
    if (ipm == IPD_VER) {
      pred = up0[ii];
    } else if (ipm == IPD_HOR) {
      pred = lr == LR_11 ? ((le0[jj] * (w - ii) + ri0[jj] * (ii + 1) +
                             (w >> 1)) * lutp1) >> 12
             : lr == LR_01 ? ri0[jj] : le0[jj];
    } else if (ipm == IPD_DC) {
      pred = s_par[0];
    } else if (ipm == IPD_PLN) {
      const int steps = right_av ? w - 1 - ii : ii;
      pred = clampi((s_par[0] + jj * s_par[2] + steps * s_par[1]) >> 5, 0,
                    maxv);
    } else if (ipm == IPD_BI) {
      const int up_i = up0[ii];
      if (lr == LR_11) {
        const int dst = ((le0[jj] * (w - ii) + ri0[jj] * (ii + 1) +
                          (w >> 1)) * lutp1) >> 12;
        const int last = ((le0[h - 1] * (w - ii) + ri0[h - 1] * (ii + 1) +
                           (w >> 1)) * lutp1) >> 12;
        const int tmp = (up_i * (h - 1 - jj) + last * (jj + 1) + (h >> 1)) >>
                        lh;
        pred = (dst + tmp + 1) >> 1;
      } else {
        const bool is01 = lr == LR_01;
        const int aa = is01 ? s_up[0] : up0[w];
        const int bb = is01 ? ri0[h] : le0[h];
        const int ish = min(lw, lh);
        const int asp = lw > lh ? lw - lh : lh - lw;
        const int cc = lw == lh
                           ? (aa + bb + 1) >> 1
                           : (((aa << lw) + (bb << lh)) *
                                  tab[T_WC + min(asp, 5)] +
                              (1 << (ish + 9))) >> (ish + 10);
        const int wt = (cc << 1) - aa - bb;
        const int ref_up = (up_i << lh) + (jj + 1) * (bb - up_i);
        const int side = is01 ? ri0[jj] : le0[jj];
        const int kpx = is01 ? w - ii : ii + 1;
        const int px = (side << lw) + kpx * (aa - side);
        const int wx = (is01 ? w - 1 - ii : ii) * jj * wt;
        pred = clampi(((px << lh) + (ref_up << lw) + wx + (1 << (lw + lh))) >>
                          (lw + lh + 1),
                      0, maxv);
      }
    } else {  // angular (jax_intra_main.py:256-317)
      int refpos, pos, off;
#define GRP(m, d, dout, o)          \
  do {                              \
    const int prod_ = (d) * (m);    \
    dout = prod_ >> 10;             \
    o = (prod_ >> 5) - (dout << 5); \
  } while (0)
      if (ipm < IPD_VER) {
        int tdx1, offa1, tdy1, offb1;
        GRP(m0, jj + 1, tdx1, offa1);
        GRP(m1, w - ii, tdy1, offb1);
        const bool cond = right_av && ii >= w - tdx1;
        refpos = cond ? 2 : 0;
        pos = cond ? jj - tdy1 : ii + tdx1;
        off = cond ? offb1 : offa1;
      } else if (ipm > IPD_HOR) {
        if (right_av) {
          int tdyr, offr, tdxr, offr2;
          GRP(m1, w - ii, tdyr, offr);
          GRP(m0, w - ii, tdxr, offr2);
          const bool cond = jj < tdyr;
          refpos = cond ? 0 : 2;
          pos = cond ? ii + tdxr : jj - tdyr;
          off = cond ? offr2 : offr;
        } else {
          int tdyl, offl;
          GRP(m1, ii + 1, tdyl, offl);
          refpos = 1;
          pos = jj + tdyl;
          off = offl;
        }
      } else {
        int tdy3, offa3, tdx3, offb3, tdy3b, offc3;
        GRP(m1, ii + 1, tdy3, offa3);
        GRP(m0, jj + 1, tdx3, offb3);
        GRP(m1, w - ii, tdy3b, offc3);
        const bool cond = jj < tdy3, is01 = lr == LR_01;
        refpos = cond ? 0 : (is01 ? 2 : 1);
        pos = cond ? ii - tdx3 : (is01 ? jj + tdy3b : jj - tdy3);
        off = cond ? offb3 : (is01 ? offc3 : offa3);
      }
#undef GRP
      const int dxy = (ipm < IPD_VER || ipm > IPD_HOR) ? -1 : 1;
      const bool asc = (refpos == 2 ? -dxy : dxy) < 0;
      const int k0 = asc ? pos - 1 : pos + 1;
      const int k2 = asc ? pos + 1 : pos - 1;
      const int k3 = asc ? pos + 2 : pos - 2;
      const int* g = refpos == 0 ? s_up : (refpos == 1 ? s_le : s_ri);
      const int* f = tab + T_ADI + 4 * clampi(off, 0, 31);
      const int acc = g[clampi(k0, -1, n - 1) + 1] * f[0] +
                      g[clampi(pos, -1, n - 1) + 1] * f[1] +
                      g[clampi(k2, -1, n - 1) + 1] * f[2] +
                      g[clampi(k3, -1, n - 1) + 1] * f[3];
      pred = clampi((acc + 64) >> 7, 0, maxv);
    }
    const int v = (int16_t)(pred + (int)rbase[(long)jj * stride + ii]);
    base[(long)jj * stride + ii] = (int16_t)clampi(v, 0, maxv);
  }
  __syncthreads();  // the neighbour arrays are reused by the next plane
}

// (jax_intra_main.py:538; ref: src_main/xevdm_ipred.c:267-305)
__device__ __forceinline__ int chroma_ipm_eff(int ipm, int ipm_c) {
  // IPD_DM_C 0, IPD_BI_C 1, IPD_DC_C 2, IPD_HOR_C 3, IPD_VER_C 4
  if (ipm_c == 0) {
    if (ipm == IPD_VER) ipm_c = 4;
    else if (ipm == IPD_HOR) ipm_c = 3;
    else if (ipm == IPD_DC) ipm_c = 2;
    else if (ipm == IPD_BI) ipm_c = 1;
  }
  return ipm_c == 0 ? ipm
         : ipm_c == 1 ? IPD_BI
         : ipm_c == 2 ? IPD_DC
         : ipm_c == 3 ? IPD_HOR : IPD_VER;
}

// CU row: x, y, log2w, log2h, ipm, ipm_c, up_mask, left_mask, right_mask,
// corner, lr, tree, valid[, do_intra, htdf_idx, htdf_avail]
__global__ void __launch_bounds__(IM_THREADS)
eipd_level_kernel(int16_t* rec_y, int16_t* rec_u, int16_t* rec_v,
                  const int16_t* res_y, const int16_t* res_u,
                  const int16_t* res_v, int stride_y, int stride_c,
                  const int32_t* __restrict__ rows, int ncol,
                  const int32_t* __restrict__ tab, int bd, int chroma) {
  __shared__ int s_up[MAX_NBR], s_le[MAX_NBR], s_ri[MAX_NBR], s_par[4];
  const int32_t* c = rows + (size_t)blockIdx.x * ncol;
  const int x = c[0], y = c[1], lw = c[2], lh = c[3], ipm = c[4];
  const uint32_t um = (uint32_t)c[6], lm = (uint32_t)c[7],
                 rm = (uint32_t)c[8];
  const int co = c[9], lr = c[10], tree = c[11];
  const bool ok = c[12] == 1 && (ncol > 13 ? c[13] : 1) == 1;
  if (ok && tree != 2)
    cu_plane(rec_y, res_y, stride_y, x, y, lw, lh, ipm, um, lm, rm, co, lr,
             2, bd, tab, s_up, s_le, s_ri, s_par);
  if (ok && chroma && tree != 1) {
    const int ipm_c = chroma_ipm_eff(ipm, c[5]);
    cu_plane(rec_u, res_u, stride_c, x >> 1, y >> 1, lw - 1, lh - 1, ipm_c,
             um, lm, rm, co, lr, 1, bd, tab, s_up, s_le, s_ri, s_par);
    cu_plane(rec_v, res_v, stride_c, x >> 1, y >> 1, lw - 1, lh - 1, ipm_c,
             um, lm, rm, co, lr, 1, bd, tab, s_up, s_le, s_ri, s_par);
  }
}

struct HtdfPar {
  const int32_t* tbl;
  int thr, shift, rnd;
};

__device__ __forceinline__ int htdf_read(int z, const HtdfPar& p) {
  const int v = z < 0 ? -z : z;
  const int w0 = v < p.thr ? p.tbl[((v + p.rnd) & p.thr) >> p.shift] : v;
  return z < 0 ? -w0 : w0;
}

// The four outputs of the 2x2 Hadamard window with top-left (a, b) of the
// ring-extended window `val` (pitch vp): o[0] goes to (a, b), o[1] to
// (a, b + 1), o[2] to (a + 1, b), o[3] to (a + 1, b + 1).
__device__ __forceinline__ int htdf_win(const int* val, int vp, int a, int b,
                                        int which, const HtdfPar& p) {
  const int x0 = val[a * vp + b], x1 = val[a * vp + b + 1];
  const int x2 = val[(a + 1) * vp + b], x3 = val[(a + 1) * vp + b + 1];
  const int y0 = x0 + x2, y1 = x1 + x3, y2 = x0 - x2, y3 = x1 - x3;
  const int t0 = y0 + y1, t1 = y0 - y1, t2 = y2 + y3, t3 = y2 - y3;
  const int z1 = htdf_read(t1, p), z2 = htdf_read(t2, p),
            z3 = htdf_read(t3, p);
  const int iy0 = t0 + z2, iy1 = z1 + z3, iy2 = t0 - z2, iy3 = z1 - z3;
  switch (which) {
    case 0: return (iy0 + iy1) >> 2;
    case 1: return (iy0 - iy1) >> 2;
    case 2: return (iy2 + iy3) >> 2;
    default: return (iy2 - iy3) >> 2;
  }
}

__global__ void __launch_bounds__(IM_THREADS)
htdf_level_kernel(int16_t* rec_y, int stride_y,
                  const int32_t* __restrict__ rows, int ncol,
                  const int32_t* __restrict__ tab, int bd) {
  __shared__ int s_val[66 * 66];
  const int32_t* c = rows + (size_t)blockIdx.x * ncol;
  if (c[12] != 1 || c[14] < 0) return;  // block-uniform
  const int x = c[0], y = c[1], w = 1 << c[2], h = 1 << c[3];
  const int avail = c[15];
  const int ti = clampi(c[14], 0, 4);
  const int thr_log2 = tab[T_HTHR + ti];
  HtdfPar p;
  p.tbl = tab + T_HTDF + 16 * ti;
  p.shift = thr_log2 - 4;
  p.rnd = (1 << p.shift) >> 1;
  p.thr = (1 << thr_log2) - (1 << p.shift);
  const int maxv = (1 << bd) - 1;
  // e(a, b) = plane sample (y - 1 + a, x - 1 + b)
  int16_t* e = rec_y + (long)(BORDER + y - 1) * stride_y + BORDER + x - 1;
  const int vp = w + 2;

  // the ring-extended window, staged before any write (it overlaps the
  // CU's own output)
  for (int i = threadIdx.x; i < (h + 2) * vp; i += blockDim.x) {
    const int r = i / vp, cc = i - r * vp;
    int er, ec;
    if (r == 0 && cc == 0) {
      er = (avail & 8) ? 0 : 1;  ec = er;
    } else if (r == 0 && cc == w + 1) {
      const bool a = avail & 16;  er = a ? 0 : 1;  ec = a ? w + 1 : w;
    } else if (r == h + 1 && cc == 0) {
      const bool a = avail & 32;  er = a ? h + 1 : h;  ec = a ? 0 : 1;
    } else if (r == h + 1 && cc == w + 1) {
      const bool a = avail & 64;  er = a ? h + 1 : h;  ec = a ? w + 1 : w;
    } else {
      er = r == 0 ? ((avail & 4) ? 0 : 1) : min(r, h);
      ec = cc == 0 ? ((avail & 1) ? 0 : 1)
           : cc == w + 1 ? ((avail & 2) ? w + 1 : w) : min(cc, w);
    }
    s_val[i] = e[(long)er * stride_y + ec];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < w * h; i += blockDim.x) {
    const int r = (i / w) + 1, cc = (i % w) + 1;  // ring coordinates
    const int acc = htdf_win(s_val, vp, r, cc, 0, p) +
                    htdf_win(s_val, vp, r, cc - 1, 1, p) +
                    htdf_win(s_val, vp, r - 1, cc, 2, p) +
                    htdf_win(s_val, vp, r - 1, cc - 1, 3, p);
    e[(long)r * stride_y + cc] = (int16_t)clampi((acc + 2) >> 2, 0, maxv);
  }
}

}  // namespace

// level_off: HOST array of n_levels + 1 row offsets into `rows` (the level
// schedule); every other pointer is on the device.
extern "C" int xevd_intra_scan_wave(void* rec_y, void* rec_u, void* rec_v,
                                    const void* res_y, const void* res_u,
                                    const void* res_v, int stride_y,
                                    int stride_c, const void* rows, int ncol,
                                    const int32_t* level_off, int n_levels,
                                    const void* tab, int bd, int chroma,
                                    void* stream) {
  if (ncol != 13 && ncol != 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* r = (const int32_t*)rows;
  for (int l = 0; l < n_levels; ++l) {
    const int n = level_off[l + 1] - level_off[l];
    if (n <= 0) continue;
    const int32_t* lr = r + (size_t)level_off[l] * ncol;
    eipd_level_kernel<<<n, IM_THREADS, 0, s>>>(
        (int16_t*)rec_y, (int16_t*)rec_u, (int16_t*)rec_v,
        (const int16_t*)res_y, (const int16_t*)res_u, (const int16_t*)res_v,
        stride_y, stride_c, lr, ncol, (const int32_t*)tab, bd, chroma);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (ncol == 16) {
      htdf_level_kernel<<<n, IM_THREADS, 0, s>>>(
          (int16_t*)rec_y, stride_y, lr, ncol, (const int32_t*)tab, bd);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}
