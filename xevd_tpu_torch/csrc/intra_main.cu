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
// 1080p I picture of the smoke's Main stream: 7,397 CUs in 839 levels), so
// a level is a short dependent step: neighbour loads, a few barriers, at
// most 64 x 64 outputs a CU.  The time is the chain of levels times the
// latency of one CU's step, not bandwidth or arithmetic.
//
// Design: one persistent launch a frame, a grid of the CTAs that fit on
// the card at once, each with the tables in shared memory.  Each CTA
// takes rows by ticket (scan.cuh), so in table order, which is level
// order.  Row n of level L (a binary search of the device level offsets,
// as csrc/batch.cuh finds a frame) waits until the count of finished rows
// reaches level_off[L], the number of rows of the levels before L: the
// first time the count reaches it, only rows of earlier levels can have
// finished (a row of level >= L starts only after it), so all of them
// have, and empty levels need no care.  The CTA then
// runs its CU in one pass over luma, u and v together, with one round trip
// to memory after the wait:
// 1. before the wait: the residuals of its planes into shared memory;
// 2. after it, every load at once: each plane's neighbour samples at their
//    last-available positions (masks only, no data needed), its corner,
//    and for HTDF the ring samples outside the CU (and the CU's own luma
//    where this row does not predict it);
// 3. the fill seeds resolved in shared memory, DC / PLANE sums a warp a
//    plane, then every sample of every plane predicted;
// 4. with HTDF, luma goes to the window in shared memory instead of the
//    plane, the ring's replicated samples are copied from it, and the
//    filtered block is written: the CU's own HTDF, from its planes after
//    its own prediction.
// Then it adds one to the count.  Fusing HTDF per CU is exact because the
// host schedule (host/ops/wavefront.py:94-101) puts every CU after the
// writers of its whole one-cell HTDF ring: no CU of the same level writes a
// sample that another's prediction or ring reads (ops/intra_main.py
// `wave_level_check_ref` is the rule).  Only a CU's own mode is evaluated
// (the JAX version evaluates all 33 on a tile and selects).
#include <cuda_runtime.h>
#include <stdint.h>

#include "batch.cuh"
#include "scan.cuh"

#define BORDER 72
#define IM_THREADS 256
#define MAX_N 128    // w + h for a 64 x 64 CU: neighbour samples a direction
#define MAX_AREA (64 * 64 + 2 * 32 * 32)   // luma + u + v samples of a CU
#define SENT ((int)0x80000000)             // a sample left to its fill seed

// offsets into the flat table of TAB_N ints (ops/tables.py
// INTRA_MAIN_PARTS, INTRA_MAIN_LEN)
#define TAB_N 305
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

// The position whose sample fills neighbour sample k of one direction:
// unit u = k >> lg is available where bit u of `mask` is set; an
// unavailable sample takes the last sample of the nearest available unit
// before it, and -1 means none (the direction's seed).
__device__ __forceinline__ int fill_pos(int k, uint32_t mask, int lg) {
  const int u = k >> lg;
  const uint32_t upto = (u >= 31) ? 0xffffffffu : ((2u << u) - 1u);
  const uint32_t bits = mask & upto;
  if (bits == 0u) return -1;
  const int last = 31 - __clz(bits);
  return last == u ? k : (last << lg) + (1 << lg) - 1;
}

__device__ __forceinline__ int get_dc(int numer, int lw, int lh,
                                      const int32_t* tab) {
  const int asp = lw > lh ? lw - lh : lh - lw;
  return (numer * tab[T_LUTP1 + min(asp, 7)]) >> (min(lw, lh) + 12);
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

// One plane of the CU: its block, its residual, its size and mode.
struct Plane {
  int16_t* base;         // the block's top-left sample
  const int16_t* rbase;  // its residual
  int stride, lw, lh, ipm, lg;
};

// The CU's three blocks: luma, then u and v (4:2:0).
struct Cu {
  int16_t *y, *u, *v;           // the blocks' top-left samples
  const int16_t *ry, *ru, *rv;  // their residuals
  int sy, sc, lw, lh, ipm, ipm_c;
};

// Plane slot s (0 luma, 1 u, 2 v) of the CU, chosen by selects: an array
// of planes indexed at run time would live in local memory.
__device__ __forceinline__ Plane plane_of(const Cu& cu, int s) {
  Plane q;
  q.base = s == 0 ? cu.y : (s == 1 ? cu.u : cu.v);
  q.rbase = s == 0 ? cu.ry : (s == 1 ? cu.ru : cu.rv);
  q.stride = s == 0 ? cu.sy : cu.sc;
  q.lw = s == 0 ? cu.lw : cu.lw - 1;
  q.lh = s == 0 ? cu.lh : cu.lh - 1;
  q.ipm = s == 0 ? cu.ipm : cu.ipm_c;
  q.lg = s == 0 ? 2 : 1;
  return q;
}

// Item i of a pass over the enabled slots, n0 items for luma (0 when it is
// off) and n1 for each chroma slot: its slot s and its index j there.
__device__ __forceinline__ void locate(int i, int n0, int n1, int& s,
                                       int& j) {
  if (i < n0) {
    s = 0;
    j = i;
  } else {
    const int k = i - n0;
    s = k < n1 ? 1 : 2;
    j = k < n1 ? k : k - n1;
  }
}

// The filled neighbour arrays of one plane: nb[d][k + 1] = sample k of
// direction d (0 up, 1 left, 2 right), nb[d][0] = position -1.
typedef int Nbr[3][MAX_N + 1];

// The scalars of DC (par[0]) and PLANE (par[0..2]) of one plane: sums by
// one warp.
__device__ __forceinline__ void plane_par(const Plane& q, const Nbr& nb,
                                          int lr,
                                          const int32_t* __restrict__ tab,
                                          int* par) {
  const int lane = threadIdx.x & 31;
  const int ipm = q.ipm, lw = q.lw, lh = q.lh;
  const int w = 1 << lw, h = 1 << lh, w2 = w >> 1, h2 = h >> 1;
  const int* up0 = nb[0] + 1;
  const int* le0 = nb[1] + 1;
  const int* ri0 = nb[2] + 1;
  const bool right_av = (lr & 2) != 0;
  int a = 0, b = 0, c = 0;
  if (ipm == IPD_DC) {
    for (int k = lane; k < h; k += 32) { a += le0[k]; b += ri0[k]; }
    for (int k = lane; k < w; k += 32) c += up0[k];
  } else {
    for (int k = lane + 1; k <= w2; k += 32)
      a += right_av ? k * (nb[0][1 + w2 - k] - nb[0][1 + w2 + k])
                    : k * (nb[0][w2 + k] - nb[0][w2 - k]);
    for (int k = lane + 1; k <= h2; k += 32)
      b += right_av ? k * (nb[2][h2 + k] - nb[2][h2 - k])
                    : k * (nb[1][h2 + k] - nb[1][h2 - k]);
  }
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  if (lane != 0) return;
  if (ipm == IPD_DC) {
    par[0] = lr == LR_11 ? get_dc(a + b + c + ((w + h + h) >> 1), lw, lh + 1,
                                  tab)
             : lr == LR_01 ? get_dc(b + c + ((w + h) >> 1), lw, lh, tab)
                           : get_dc(a + c + ((w + h) >> 1), lw, lh, tab);
  } else {
    const int iw = lw > 2 ? lw - 2 : 0, ih = lh > 2 ? lh - 2 : 0;
    const int ibs_w = tab[T_IBS + iw], ibs_h = tab[T_IBS + ih];
    const int pb = ((a << 5) * tab[T_IBM + iw] + (1 << (ibs_w - 1))) >> ibs_w;
    const int pc = ((b << 5) * tab[T_IBM + ih] + (1 << (ibs_h - 1))) >> ibs_h;
    const int pa = right_av ? (ri0[h - 1] + up0[0]) << 4
                            : (le0[h - 1] + up0[w - 1]) << 4;
    par[0] = pa - (h2 - 1) * pc - (w2 - 1) * pb + 16;  // temp0
    par[1] = pb;
    par[2] = pc;
  }
}

// The prediction of sample (row jj, column ii) of one plane.
__device__ __forceinline__ int predict_at(const Plane& q, const Nbr& nb,
                                          const int* par, int lr, int jj,
                                          int ii, int maxv,
                                          const int32_t* __restrict__ tab) {
  const int ipm = q.ipm, lw = q.lw, lh = q.lh;
  const int w = 1 << lw, h = 1 << lh, n = w + h;
  const int* up0 = nb[0] + 1;
  const int* le0 = nb[1] + 1;
  const int* ri0 = nb[2] + 1;
  const bool right_av = (lr & 2) != 0;
  const int lutp1 = tab[T_LUTP1 + lw];
  if (ipm == IPD_VER) return up0[ii];
  if (ipm == IPD_HOR)
    return lr == LR_11 ? ((le0[jj] * (w - ii) + ri0[jj] * (ii + 1) +
                           (w >> 1)) * lutp1) >> 12
           : lr == LR_01 ? ri0[jj] : le0[jj];
  if (ipm == IPD_DC) return par[0];
  if (ipm == IPD_PLN) {
    const int steps = right_av ? w - 1 - ii : ii;
    return clampi((par[0] + jj * par[2] + steps * par[1]) >> 5, 0, maxv);
  }
  if (ipm == IPD_BI) {
    const int up_i = up0[ii];
    if (lr == LR_11) {
      const int dst = ((le0[jj] * (w - ii) + ri0[jj] * (ii + 1) + (w >> 1)) *
                       lutp1) >> 12;
      const int last = ((le0[h - 1] * (w - ii) + ri0[h - 1] * (ii + 1) +
                         (w >> 1)) * lutp1) >> 12;
      const int tmp = (up_i * (h - 1 - jj) + last * (jj + 1) + (h >> 1)) >>
                      lh;
      return (dst + tmp + 1) >> 1;
    }
    const bool is01 = lr == LR_01;
    const int aa = is01 ? nb[0][0] : up0[w];
    const int bb = is01 ? ri0[h] : le0[h];
    const int ish = min(lw, lh);
    const int asp = lw > lh ? lw - lh : lh - lw;
    const int cc = lw == lh ? (aa + bb + 1) >> 1
                            : (((aa << lw) + (bb << lh)) *
                                   tab[T_WC + min(asp, 5)] +
                               (1 << (ish + 9))) >> (ish + 10);
    const int wt = (cc << 1) - aa - bb;
    const int ref_up = (up_i << lh) + (jj + 1) * (bb - up_i);
    const int side = is01 ? ri0[jj] : le0[jj];
    const int kpx = is01 ? w - ii : ii + 1;
    const int px = (side << lw) + kpx * (aa - side);
    const int wx = (is01 ? w - 1 - ii : ii) * jj * wt;
    return clampi(((px << lh) + (ref_up << lw) + wx + (1 << (lw + lh))) >>
                      (lw + lh + 1),
                  0, maxv);
  }
  // angular (jax_intra_main.py:256-317)
  const int m0 = tab[T_DXDY + 2 * clampi(ipm, 0, 32)];
  const int m1 = tab[T_DXDY + 2 * clampi(ipm, 0, 32) + 1];
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
  const int* g = nb[refpos];
  const int* f = tab + T_ADI + 4 * clampi(off, 0, 31);
  const int acc = g[clampi(k0, -1, n - 1) + 1] * f[0] +
                  g[clampi(pos, -1, n - 1) + 1] * f[1] +
                  g[clampi(k2, -1, n - 1) + 1] * f[2] +
                  g[clampi(k3, -1, n - 1) + 1] * f[3];
  return clampi((acc + 64) >> 7, 0, maxv);
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

// Ring position q (0 .. 2 (w + 2) + 2 h) of the (h + 2) x (w + 2) HTDF
// window: (r, cc), and (er, ec), the window position whose sample it
// takes under the availability bits (the CU's own edge where a side is
// unavailable; the bottom row always its own).
__device__ __forceinline__ void ring_at(int q, int w, int h, int avail,
                                        int& r, int& cc, int& er, int& ec) {
  if (q < w + 2) {
    r = 0;  cc = q;
  } else if (q < 2 * (w + 2)) {
    r = h + 1;  cc = q - (w + 2);
  } else {
    r = 1 + ((q - 2 * (w + 2)) >> 1);
    cc = (q & 1) ? w + 1 : 0;
  }
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
         : cc == w + 1 ? ((avail & 2) ? w + 1 : w) : cc;
  }
}

// sync: device int32 [2], zeroed: the ticket counter, the finished rows.
// CU row: x, y, log2w, log2h, ipm, ipm_c, up_mask, left_mask, right_mask,
// corner, lr, tree, valid[, do_intra, htdf_idx, htdf_avail]
__global__ void __launch_bounds__(IM_THREADS)
eipd_scan_kernel(int16_t* rec_y, int16_t* rec_u, int16_t* rec_v,
                 const int16_t* res_y, const int16_t* res_u,
                 const int16_t* res_v, int stride_y, int stride_c,
                 const int32_t* __restrict__ rows, int ncol, int n_rows,
                 const int32_t* __restrict__ level_off, int n_levels,
                 const int32_t* __restrict__ tab, int bd, int chroma,
                 int* sync) {
  __shared__ int s_raw[3][3][MAX_N];   // loaded samples, SENT for a seed
  __shared__ Nbr s_nb[3];
  __shared__ int s_cor[3], s_par[3][4], s_n[2];
  __shared__ int s_val[66 * 66];       // the HTDF window
  __shared__ int16_t s_res[MAX_AREA];
  __shared__ int32_t s_tab[TAB_N];     // the tables, read at every sample
  const int t = threadIdx.x;
  for (int i = t; i < TAB_N; i += blockDim.x) s_tab[i] = tab[i];
  const int maxv = (1 << bd) - 1, mid = 1 << (bd - 1);
  for (int it = 0;; ++it) {
    const int n = take_ticket(sync, s_n, it);
    if (n >= n_rows) return;
    const int32_t* c = rows + (size_t)n * ncol;
    const int x = c[0], y = c[1], lw = c[2], lh = c[3];
    const int co = c[9], lr = c[10], tree = c[11];
    // the row's fields are all read here: after the wait's fence they
    // would be loaded again
    const uint32_t um = (uint32_t)c[6], lm = (uint32_t)c[7],
                   rm = (uint32_t)c[8];
    const int hidx = ncol == 16 ? c[14] : -1, avail = ncol == 16 ? c[15] : 0;
    const bool ok = c[12] == 1 && (ncol > 13 ? c[13] : 1) == 1;
    const bool luma = ok && tree != 2;      // predicts luma (slot 0)
    const bool cpl = ok && chroma && tree != 1;   // predicts u and v
    const bool htdf = c[12] == 1 && hidx >= 0;
    const long oy = (long)(BORDER + y) * stride_y + BORDER + x;
    const long oc = chroma ? (long)(BORDER + (y >> 1)) * stride_c + BORDER +
                                 (x >> 1)
                           : 0;
    const Cu cu = {rec_y + oy, rec_u + oc, rec_v + oc, res_y + oy,
                   res_u + oc, res_v + oc, stride_y, stride_c, lw, lh, c[4],
                   chroma_ipm_eff(c[4], c[5])};
    const int w = 1 << lw, h = 1 << lh, vp = w + 2;
    const int al = luma ? w * h : 0, ac = cpl ? (w * h) >> 2 : 0;
    const int nb_l = luma ? 3 * (w + h) + 1 : 0;   // neighbour loads
    const int nb_c = cpl ? 3 * ((w + h) >> 1) + 1 : 0;

    // 1. the residuals, before the wait (nothing in the scan writes them)
    for (int i = t; i < al + 2 * ac; i += blockDim.x) {
      int p, j;
      locate(i, al, ac, p, j);
      const Plane q = plane_of(cu, p);
      s_res[i] = __ldg(q.rbase + (long)(j >> q.lw) * q.stride +
                       (j & ((1 << q.lw) - 1)));
    }
    // the rows of the levels before this row's (never more than n: a
    // malformed schedule cannot make a row wait on a later ticket)
    if (t == 0)
      wait_at_least(sync + 1,
                    min(level_off[batch_of(level_off, n_levels, n)], n));
    __syncthreads();

    // 2. every load of the CU at once; samples other CTAs wrote come from
    // L2 (scan.cuh)
    for (int i = t; i < nb_l + 2 * nb_c; i += blockDim.x) {
      int p, e;
      locate(i, nb_l, nb_c, p, e);
      const Plane q = plane_of(cu, p);
      const int pw = 1 << q.lw, nn = pw + (1 << q.lh);
      if (e == 3 * nn) {
        s_cor[p] = co == 1 ? (int)__ldcg(q.base - q.stride - 1) : 0;
        continue;
      }
      const int d = e / nn, k = e - d * nn;
      const int pos = fill_pos(k, d == 0 ? um : (d == 1 ? lm : rm), q.lg);
      const int16_t* src =
          d == 0 ? q.base + pos - q.stride
                 : q.base + (long)pos * q.stride + (d == 1 ? -1 : pw);
      s_raw[p][d][k] = pos < 0 ? SENT : (int)__ldcg(src);
    }
    if (htdf) {
      const int16_t* e = rec_y + oy - stride_y - 1;  // window (0, 0)
      for (int q = t; q < 2 * (w + 2) + 2 * h; q += blockDim.x) {
        int r, cc, er, ec;
        ring_at(q, w, h, avail, r, cc, er, ec);
        if (er == 0 || er == h + 1 || ec == 0 || ec == w + 1)
          s_val[r * vp + cc] = __ldcg(e + (long)er * stride_y + ec);
      }
      if (!luma)   // its luma as recon or an earlier level left it
        for (int i = t; i < w * h; i += blockDim.x)
          s_val[((i >> lw) + 1) * vp + (i & (w - 1)) + 1] =
              __ldcg(e + (long)((i >> lw) + 1) * stride_y + (i & (w - 1)) +
                     1);
    }
    __syncthreads();

    // 3. the filled neighbour arrays: the up row seeded by the corner or
    // mid, up[-1] the corner or the filled up[0], which seeds the left
    // column, the right column seeded by the filled up[w]
    for (int i = t; i < 3 * 3 * (MAX_N + 1); i += blockDim.x) {
      const int p = i / (3 * (MAX_N + 1));
      const int d = (i / (MAX_N + 1)) % 3, k1 = i % (MAX_N + 1);
      const int pw = p == 0 ? w : w >> 1, nn = p == 0 ? w + h : (w + h) >> 1;
      if (k1 > nn || !(p == 0 ? luma : cpl)) continue;
      const int seed_up = co == 1 ? s_cor[p] : mid;
      const int r0 = s_raw[p][0][0], rw = s_raw[p][0][pw];
      const int up_m1 = co == 1 ? s_cor[p] : (r0 == SENT ? seed_up : r0);
      const int ri_m1 = rw == SENT ? seed_up : rw;
      const int seed = d == 0 ? seed_up : (d == 1 ? up_m1 : ri_m1);
      int v = k1 == 0 ? (d == 2 ? ri_m1 : up_m1) : s_raw[p][d][k1 - 1];
      s_nb[p][d][k1] = v == SENT ? seed : v;
    }
    __syncthreads();
    const int wp = t >> 5;
    if (wp < 3 && (wp == 0 ? luma : cpl)) {
      const Plane q = plane_of(cu, wp);
      if (q.ipm == IPD_DC || q.ipm == IPD_PLN)
        plane_par(q, s_nb[wp], lr, s_tab, s_par[wp]);
    }
    __syncthreads();

    // 4. every sample of every plane; luma into the HTDF window when the
    // CU's own HTDF follows
    for (int i = t; i < al + 2 * ac; i += blockDim.x) {
      int p, j;
      locate(i, al, ac, p, j);
      const Plane q = plane_of(cu, p);
      const int jj = j >> q.lw, ii = j & ((1 << q.lw) - 1);
      const int pred =
          predict_at(q, s_nb[p], s_par[p], lr, jj, ii, maxv, s_tab);
      const int v = clampi((int16_t)(pred + (int)s_res[i]), 0, maxv);
      if (htdf && luma && p == 0)
        s_val[(jj + 1) * vp + ii + 1] = v;
      else
        q.base[(long)jj * q.stride + ii] = (int16_t)v;
    }
    if (htdf) {
      __syncthreads();
      for (int q = t; q < 2 * (w + 2) + 2 * h; q += blockDim.x) {
        int r, cc, er, ec;
        ring_at(q, w, h, avail, r, cc, er, ec);
        if (!(er == 0 || er == h + 1 || ec == 0 || ec == w + 1))
          s_val[r * vp + cc] = s_val[er * vp + ec];
      }
      __syncthreads();
      const int ti = clampi(hidx, 0, 4);
      const int thr_log2 = s_tab[T_HTHR + ti];
      HtdfPar hp;
      hp.tbl = s_tab + T_HTDF + 16 * ti;
      hp.shift = thr_log2 - 4;
      hp.rnd = (1 << hp.shift) >> 1;
      hp.thr = (1 << thr_log2) - (1 << hp.shift);
      int16_t* base = rec_y + oy;
      for (int i = t; i < w * h; i += blockDim.x) {
        const int r = (i >> lw) + 1, cc = (i & (w - 1)) + 1;
        const int acc = htdf_win(s_val, vp, r, cc, 0, hp) +
                        htdf_win(s_val, vp, r, cc - 1, 1, hp) +
                        htdf_win(s_val, vp, r - 1, cc, 2, hp) +
                        htdf_win(s_val, vp, r - 1, cc - 1, 3, hp);
        base[(long)(r - 1) * stride_y + cc - 1] =
            (int16_t)clampi((acc + 2) >> 2, 0, maxv);
      }
    }
    __syncthreads();
    if (t == 0) add_release(sync + 1, 1);
  }
}

}  // namespace

// The persistent grid of the scan kernel: the CTAs that fit on the current
// device at once (one launch uses min(this, rows)).
extern "C" int xevd_intra_scan_wave_grid(int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, eipd_scan_kernel,
                                                IM_THREADS, 0);
  *grid = sms * per_sm;
  return (int)cudaGetLastError();
}

// level_off: device int32 [n_levels + 1] row offsets of the levels in
// `rows`; sync: device int32 [2], zeroed.  One launch.
extern "C" int xevd_intra_scan_wave(void* rec_y, void* rec_u, void* rec_v,
                                    const void* res_y, const void* res_u,
                                    const void* res_v, int stride_y,
                                    int stride_c, const void* rows, int ncol,
                                    int n_rows, const void* level_off,
                                    int n_levels, const void* tab, int bd,
                                    int chroma, void* sync, void* stream) {
  if (ncol != 13 && ncol != 16) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0 || n_levels <= 0) return (int)cudaGetLastError();
  int grid = 0;
  const int err = xevd_intra_scan_wave_grid(&grid);
  if (err != cudaSuccess) return err;
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  eipd_scan_kernel<<<grid < n_rows ? grid : n_rows, IM_THREADS, 0,
                     (cudaStream_t)stream>>>(
      (int16_t*)rec_y, (int16_t*)rec_u, (int16_t*)rec_v,
      (const int16_t*)res_y, (const int16_t*)res_u, (const int16_t*)res_v,
      stride_y, stride_c, (const int32_t*)rows, ncol, n_rows,
      (const int32_t*)level_off, n_levels, (const int32_t*)tab, bd, chroma,
      (int*)sync);
  return (int)cudaGetLastError();
}
