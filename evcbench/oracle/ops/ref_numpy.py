"""Bit-exact numpy implementation of the Baseline pixel pipeline.

This is the scalar-semantics oracle: each function mirrors the normative
integer arithmetic (ref: src_base/xevd_itdq.c, xevd_ipred.c, xevd_mc.c,
xevd_recon.c, xevd_df.c).  The JAX/Pallas kernels in this package are
unit-tested against these functions, and this backend can also run the full
decoder on host for conformance debugging.
"""
from __future__ import annotations

import numpy as np

from .. import tables as T


# ---------------------------------------------------------------------------
# Inverse transform + dequant  (ref: src_base/xevd_itdq.c:473-541)
# ---------------------------------------------------------------------------
def itdq_block(coef: np.ndarray, log2_w: int, log2_h: int, scale: int,
               bit_depth: int, iqt: bool = False, ats_cu: int = 0,
               ats_mode: int = 0) -> np.ndarray:
    """Dequant + 2-stage inverse DCT-2 of one TU; returns int16 residual.

    Mirrors xevd_itdq + xevd_itrans (ref: src_base/xevd_itdq.c:473-541):
    stage 0 (columns) has shift 0 into an int32 buffer, stage 1 (rows)
    applies the combined shift ITX_SHIFT1 + ITX_SHIFT2(bd).
    """
    ns_scale = 181 if ((log2_w + log2_h) & 1) else 1
    ns_shift = 8 if ((log2_w + log2_h) & 1) else 0
    log2_size = (log2_w + log2_h) >> 1
    tr_shift = T.MAX_TX_DYNAMIC_RANGE - bit_depth - log2_size
    shift = T.QUANT_IQUANT_SHIFT - T.QUANT_SHIFT - tr_shift + ns_shift
    offset = 0 if shift == 0 else 1 << (shift - 1)

    c = coef.astype(np.int64)
    lev = (c * (scale * ns_scale) + offset) >> shift
    dq = np.clip(lev, -32768, 32767).astype(np.int64)

    if ats_cu:
        # ATS intra/inter DST-7/DCT-8, two clipped 16-bit stages
        # (ref: src_main/xevdm_itdq.c:405-421,163-405)
        tr_h = (T.TR_DCT8 if (ats_mode >> 1) else T.TR_DST7)[log2_w]
        tr_v = (T.TR_DCT8 if (ats_mode & 1) else T.TR_DST7)[log2_h]
        s1 = (dq.T @ tr_v + (1 << 6)) >> 7                  # [w, h]
        s1 = np.clip(s1, -32768, 32767)
        shift2 = 6 + 15 - 1 - bit_depth
        r = (s1.T @ tr_h + (1 << (shift2 - 1))) >> shift2   # [h, w]
        r = np.clip(r, -32768, 32767)
        return r.astype(np.int16)

    if iqt:
        # Main per-stage DCT-2 (tool_iqt): shift 7 then 12-(bd-8), 15-bit
        # clip at each stage (ref: src_main/xevdm_itdq.c:423-708)
        tm_h = T.TM[log2_h].astype(np.int64)
        tm_w = T.TM[log2_w].astype(np.int64)
        s1 = (dq.T @ tm_h + (1 << 6)) >> 7                  # [w, h]
        s1 = np.clip(s1, T.MIN_TX_VAL, T.MAX_TX_VAL)
        shift2 = 12 - (bit_depth - 8)
        r = (s1.T @ tm_w + (1 << (shift2 - 1))) >> shift2
        r = np.clip(r, T.MIN_TX_VAL, T.MAX_TX_VAL)
        return r.astype(np.int16)

    tm_h = T.TM[log2_h].astype(np.int64)   # [cuh, cuh] freq x spatial
    tm_w = T.TM[log2_w].astype(np.int64)
    # stage 0: out0[y, u] = sum_v tm_h[v, y] * dq[v, u], no shift, clip s32
    s0 = tm_h.T @ dq
    s0 = np.clip(s0, -(2**31 - 1), 2**31 - 1)
    # stage 1: r[y, x] = (sum_u s0[y, u] * tm_w[u, x] + add) >> shift2, clip s16
    shift2 = 7 + (12 - (bit_depth - 8))
    add = 1 << (shift2 - 1)
    r = (s0 @ tm_w + add) >> shift2
    r = np.clip(r, T.MIN_TX_VAL, T.MAX_TX_VAL)
    return r.astype(np.int16)


def qp_scale(qp: int, iqt: bool = False) -> int:
    """Dequant scale; tool_iqt selects the Main table
    (ref: src_base/xevd_itdq.c:595, src_main/xevdm_itdq.c:826-833)."""
    tbl = T.DQ_SCALE if iqt else T.DQ_SCALE_B
    return int(tbl[qp % 6]) << (qp // 6)


# ---------------------------------------------------------------------------
# Intra prediction  (ref: src_base/xevd_ipred.c)
# ---------------------------------------------------------------------------
def build_nbr(rec: np.ndarray, x: int, y: int, w: int, h: int,
              up_mask: int, left_mask: int, corner: int, unit: int,
              bit_depth: int):
    """Build (left, up, corner) neighbor arrays with per-unit availability
    (ref: src_base/xevd_ipred.c:33-93).  `unit` = samples per 4x4-SCU unit
    (4 luma, 2 chroma 4:2:0); number of units = (w + h) // unit.
    """
    mid = 1 << (bit_depth - 1)
    n_units = (w + h) // unit
    up = np.full(w + h, mid, dtype=np.int32)
    left = np.full(w + h, mid, dtype=np.int32)
    H, W = rec.shape
    for u in range(n_units):
        if (up_mask >> u) & 1:
            x0 = x + u * unit
            up[u * unit:(u + 1) * unit] = rec[y - 1, x0:x0 + unit]
    for u in range(n_units):
        if (left_mask >> u) & 1:
            y0 = y + u * unit
            left[u * unit:(u + 1) * unit] = rec[y0:y0 + unit, x - 1]
    corner_val = rec[y - 1, x - 1] if corner else mid
    return left, up, int(corner_val)


def ipred_b(left: np.ndarray, up: np.ndarray, corner: int, ipm: int,
            w: int, h: int) -> np.ndarray:
    """5-mode baseline intra prediction (ref: src_base/xevd_ipred.c:95-676).

    Baseline CUs are square (QT-only partitioning).
    """
    if ipm == T.IPD_VER_B:
        return np.broadcast_to(up[:w], (h, w)).astype(np.int32)
    if ipm == T.IPD_HOR_B:
        return np.broadcast_to(left[:h, None], (h, w)).astype(np.int32)
    if ipm == T.IPD_DC_B:
        dc = (int(left[:h].sum()) + int(up[:w].sum()) + w) >> (int(T.TBL_LOG2[w]) + 1)
        return np.full((h, w), dc, dtype=np.int32)
    if ipm == T.IPD_UL_B:
        out = np.zeros((h, w), dtype=np.int32)
        ii = np.arange(h)[:, None]
        jj = np.arange(w)[None, :]
        diag = ii - jj
        out = np.where(diag > 0, left[np.clip(diag - 1, 0, h + w - 1)],
                       np.where(diag == 0, corner,
                                up[np.clip(-diag - 1, 0, h + w - 1)]))
        return out.astype(np.int32)
    if ipm == T.IPD_UR_B:
        ii = np.arange(h)[:, None]
        jj = np.arange(w)[None, :]
        k = ii + jj + 1
        return ((up[k] + left[k]) >> 1).astype(np.int32)
    raise ValueError(f"bad baseline ipm {ipm}")


# ---------------------------------------------------------------------------
# Motion compensation  (ref: src_base/xevd_mc.c)
# ---------------------------------------------------------------------------
def mv_clip(x, y, pic_w, pic_h, w, h, mv):
    """Clip one MV to the padded frame (ref: src_base/xevd_mc.c:435-467)."""
    mvx, mvy = int(mv[0]), int(mv[1])
    x4, y4, w4, h4 = x << 2, y << 2, w << 2, h << 2
    lo = -(T.MAX_CU_SIZE << 2)
    hix = (pic_w - 1 + T.MAX_CU_SIZE) << 2
    hiy = (pic_h - 1 + T.MAX_CU_SIZE) << 2
    ox, oy = mvx, mvy
    if x4 + mvx < lo:
        ox = lo - x4
    if y4 + mvy < lo:
        oy = lo - y4
    if x4 + mvx + w4 - 4 > hix:
        ox = hix - x4 - w4 + 4
    if y4 + mvy + h4 - 4 > hiy:
        oy = hiy - y4 - h4 + 4
    return ox, oy


def mc_luma(ref: np.ndarray, gmv_x: int, gmv_y: int, frac_x: int, frac_y: int,
            w: int, h: int, bit_depth: int, pad: int,
            main_taps: bool = False) -> np.ndarray:
    """Luma MC for one block.  `ref` is the padded plane, gmv_* in 1/16-pel
    relative to the padded origin. frac_* select the kernel variant from the
    *pre-clipping* MV (ref: src_base/xevd_mc.h:65-69, xevd_mc.c:169-284).
    main_taps selects the ADMVP filter set (ref: src_main/xevdm_mc.c:121)."""
    LTAPS = T.MC_L_COEFF_MAIN if main_taps else T.MC_L_COEFF
    maxv = (1 << bit_depth) - 1
    if frac_x == 0 and frac_y == 0:
        ix, iy = gmv_x >> 4, gmv_y >> 4
        return ref[iy:iy + h, ix:ix + w].astype(np.int32)
    if frac_x != 0 and frac_y == 0:
        dx = gmv_x & 15
        ix = (gmv_x >> 4) - 3
        iy = gmv_y >> 4
        win = ref[iy:iy + h, ix:ix + w + 7].astype(np.int32)
        taps = LTAPS[dx]
        acc = np.zeros((h, w), dtype=np.int32)
        for k in range(8):
            acc += taps[k] * win[:, k:k + w]
        return np.clip(acc >> 6, 0, maxv)
    if frac_x == 0 and frac_y != 0:
        dy = gmv_y & 15
        ix = gmv_x >> 4
        iy = (gmv_y >> 4) - 3
        win = ref[iy:iy + h + 7, ix:ix + w].astype(np.int32)
        taps = LTAPS[dy]
        acc = np.zeros((h, w), dtype=np.int32)
        for k in range(8):
            acc += taps[k] * win[k:k + h, :]
        return np.clip(acc >> 6, 0, maxv)
    # nn: separable two-stage with intermediate s16 buffer
    dx, dy = gmv_x & 15, gmv_y & 15
    ix = (gmv_x >> 4) - 3
    iy = (gmv_y >> 4) - 3
    shift1 = min(4, bit_depth - 8)
    shift2 = max(8, 20 - bit_depth)
    offset2 = 1 << (shift2 - 1)
    win = ref[iy:iy + h + 7, ix:ix + w + 7].astype(np.int32)
    tx = LTAPS[dx]
    buf = np.zeros((h + 7, w), dtype=np.int32)
    for k in range(8):
        buf += tx[k] * win[:, k:k + w]
    buf = (buf >> shift1).astype(np.int16).astype(np.int32)
    ty = LTAPS[dy]
    acc = np.zeros((h, w), dtype=np.int32)
    for k in range(8):
        acc += ty[k] * buf[k:k + h, :]
    return np.clip((acc + offset2) >> shift2, 0, maxv)


def mc_chroma(ref: np.ndarray, gmv_x: int, gmv_y: int, frac_x: int,
              frac_y: int, w: int, h: int, bit_depth: int,
              main_taps: bool = False) -> np.ndarray:
    """Chroma MC (1/32-pel, 4-tap) (ref: src_base/xevd_mc.c:290-408).
    gmv_* in 1/16-pel luma units == 1/32-pel chroma units."""
    CTAPS = T.MC_C_COEFF_MAIN if main_taps else T.MC_C_COEFF
    maxv = (1 << bit_depth) - 1
    if frac_x == 0 and frac_y == 0:
        ix, iy = gmv_x >> 5, gmv_y >> 5
        return ref[iy:iy + h, ix:ix + w].astype(np.int32)
    if frac_x != 0 and frac_y == 0:
        dx = gmv_x & 31
        ix = (gmv_x >> 5) - 1
        iy = gmv_y >> 5
        win = ref[iy:iy + h, ix:ix + w + 3].astype(np.int32)
        taps = CTAPS[dx]
        acc = np.zeros((h, w), dtype=np.int32)
        for k in range(4):
            acc += taps[k] * win[:, k:k + w]
        return np.clip(acc >> 6, 0, maxv)
    if frac_x == 0 and frac_y != 0:
        dy = gmv_y & 31
        ix = gmv_x >> 5
        iy = (gmv_y >> 5) - 1
        win = ref[iy:iy + h + 3, ix:ix + w].astype(np.int32)
        taps = CTAPS[dy]
        acc = np.zeros((h, w), dtype=np.int32)
        for k in range(4):
            acc += taps[k] * win[k:k + h, :]
        return np.clip(acc >> 6, 0, maxv)
    dx, dy = gmv_x & 31, gmv_y & 31
    ix = (gmv_x >> 5) - 1
    iy = (gmv_y >> 5) - 1
    shift1 = min(4, bit_depth - 8)
    shift2 = max(8, 20 - bit_depth)
    offset2 = 1 << (shift2 - 1)
    win = ref[iy:iy + h + 3, ix:ix + w + 3].astype(np.int32)
    tx = CTAPS[dx]
    buf = np.zeros((h + 3, w), dtype=np.int32)
    for k in range(4):
        buf += tx[k] * win[:, k:k + w]
    buf = (buf >> shift1).astype(np.int16).astype(np.int32)
    ty = CTAPS[dy]
    acc = np.zeros((h, w), dtype=np.int32)
    for k in range(4):
        acc += ty[k] * buf[k:k + h, :]
    return np.clip((acc + offset2) >> shift2, 0, maxv)


def bi_average(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """(p0 + p1 + 1) >> 1 (ref: src_base/xevd_mc.c:145-166)."""
    return (p0 + p1 + 1) >> 1


# ---------------------------------------------------------------------------
# Reconstruction  (ref: src_base/xevd_recon.c:36-68)
# ---------------------------------------------------------------------------
def recon(pred: np.ndarray, resid, is_coef: bool, bit_depth: int) -> np.ndarray:
    maxv = (1 << bit_depth) - 1
    if not is_coef:
        return np.clip(pred, 0, maxv)
    t = resid.astype(np.int32) + pred
    t = t.astype(np.int16)  # reference adds in s16
    return np.clip(t, 0, maxv)


# ---------------------------------------------------------------------------
# Deblocking  (ref: src_base/xevd_df.c:96-289)
# ---------------------------------------------------------------------------
def _div_trunc(a, d):
    q = np.abs(a) // d
    return np.where(a < 0, -q, q)


def deblock_luma_edge(A, B, C, D, st, bit_depth):
    """4-pixel-line H.263-style filter; returns new A,B,C,D (vectorized).
    st==0 entries are returned unchanged (ref: src_base/xevd_df.c:96-135)."""
    A = A.astype(np.int32)
    B = B.astype(np.int32)
    C = C.astype(np.int32)
    D = D.astype(np.int32)
    d = _div_trunc(A - (B << 2) + (C << 2) - D, 8)
    abs_d = np.abs(d)
    sign = d < 0
    t16 = np.maximum(0, (abs_d - st) << 1)
    clip = np.maximum(0, abs_d - t16)
    d1 = np.where(sign, -clip, clip)
    clip2 = clip >> 1
    d2 = np.clip(_div_trunc(A - D, 4), -clip2, clip2)
    An = A - d2
    Bn = B + d1
    Cn = C - d1
    Dn = D + d2
    maxv = (1 << bit_depth) - 1
    on = st > 0
    return (np.where(on, np.clip(An, 0, maxv), A),
            np.where(on, np.clip(Bn, 0, maxv), B),
            np.where(on, np.clip(Cn, 0, maxv), C),
            np.where(on, np.clip(Dn, 0, maxv), D))


def deblock_chroma_edge(A, B, C, D, st, bit_depth):
    """2-tap chroma variant: only B,C change
    (ref: src_base/xevd_df.c:137-195)."""
    A = A.astype(np.int32)
    B = B.astype(np.int32)
    C = C.astype(np.int32)
    D = D.astype(np.int32)
    d = _div_trunc(A - (B << 2) + (C << 2) - D, 8)
    abs_d = np.abs(d)
    sign = d < 0
    t16 = np.maximum(0, (abs_d - st) << 1)
    clip = np.maximum(0, abs_d - t16)
    d1 = np.where(sign, -clip, clip)
    maxv = (1 << bit_depth) - 1
    on = st > 0
    Bn = np.where(on, np.clip(B + d1, 0, maxv), B)
    Cn = np.where(on, np.clip(C - d1, 0, maxv), C)
    return Bn, Cn


def deblock_frame(planes, job, sps):
    """Apply the two deblock passes to (y, u, v) in place.

    Pass order matches the reference driver: all horizontal (top) edges
    first across the frame, then all vertical (left) edges
    (ref: src_base/xevd.c:1909-1976).  Luma edges are independent; chroma
    edges 2 px apart cascade, so chroma is processed edge-column by
    edge-column in raster order (matching the z-order filter sequence).
    """
    # Pass order per the reference driver: "horizontal filtering" = filtering
    # across VERTICAL edges runs first, then vertical filtering of horizontal
    # edges (ref: src_base/xevd.c:1918-1976 with deblock_tree is_hor_edge=0
    # first, =1 second).
    deblock_pass_ver(planes, job, sps)
    deblock_pass_hor(planes, job, sps)


def _cu_deblock_order(fs):
    """Deblock visit order = decode order.  Dual-tree areas deblock twice:
    TREE_L leaves filter luma only, then the enclosing node repeats as one
    TREE_C unit filtering chroma only (ref: src_main/xevdm.c:1986-2000).
    Yields (i, do_luma, do_chroma)."""
    for i in range(fs.num_cus()):
        tree = fs.cu_tree[i]
        yield i, tree != 2, tree != 1


def deblock_pass_hor(planes, job, sps):
    """Filter the TOP edge of each CU, CUs visited in decode (SUCO) order
    (ref: src_base/xevd_df.c:291-380; order src_main/xevdm.c:1935+)."""
    y_plane, u_plane, v_plane = planes
    bd_l = sps.bit_depth_luma_minus8 + 8
    bd_c = sps.bit_depth_chroma_minus8 + 8
    fs = job.fs
    w, h = fs.w, fs.h
    cfi = sps.chroma_format_idc
    cw_shift = 1 if cfi in (1, 2) else 0
    ch_shift = 1 if cfi == 1 else 0

    for i, do_luma, do_chroma in _cu_deblock_order(fs):
        y0 = fs.cu_y[i]
        if y0 == 0 or y0 >= h:
            continue
        x0 = fs.cu_x[i]
        ys = y0 >> 2
        ypel = y0
        for xs in range(x0 >> 2, min((x0 + (1 << fs.cu_log2w[i])) >> 2,
                                     (w + 3) >> 2)):
            st = int(job.db_hor_y[ys, xs]) if do_luma else 0
            if st:
                xp = xs << 2
                n = min(4, w - xp)
                cols = slice(xp, xp + n)
                A, B, C, D = (y_plane[ypel - 2, cols], y_plane[ypel - 1, cols],
                              y_plane[ypel, cols], y_plane[ypel + 1, cols])
                A, B, C, D = deblock_luma_edge(A, B, C, D, st, bd_l)
                y_plane[ypel - 2, cols] = A
                y_plane[ypel - 1, cols] = B
                y_plane[ypel, cols] = C
                y_plane[ypel + 1, cols] = D
            if cfi and do_chroma:
                st_u = int(job.db_hor_u[ys, xs])
                st_v = int(job.db_hor_v[ys, xs])
                if st_u or st_v:
                    yc = ypel >> ch_shift
                    xp = (xs << 2) >> cw_shift
                    cols = slice(xp, xp + (4 >> cw_shift))
                    if st_u:
                        A, B, C, D = (u_plane[yc - 2, cols],
                                      u_plane[yc - 1, cols],
                                      u_plane[yc, cols], u_plane[yc + 1, cols])
                        B, C = deblock_chroma_edge(A, B, C, D, st_u, bd_c)
                        u_plane[yc - 1, cols] = B
                        u_plane[yc, cols] = C
                    if st_v:
                        A, B, C, D = (v_plane[yc - 2, cols],
                                      v_plane[yc - 1, cols],
                                      v_plane[yc, cols], v_plane[yc + 1, cols])
                        B, C = deblock_chroma_edge(A, B, C, D, st_v, bd_c)
                        v_plane[yc - 1, cols] = B
                        v_plane[yc, cols] = C


def deblock_pass_ver(planes, job, sps):
    """Vertical-edge pass: CUs visited in decode (SUCO) order; an edge is
    filtered by whichever of its two CUs is visited SECOND, tracked by a
    pass-local coded map (ref: src_base/xevd_df.c:388-545 — left edge gated
    on MCU_GET_COD(map_scu[-1]), right edge on MCU_GET_COD(map_scu[w]))."""
    y_plane, u_plane, v_plane = planes
    bd_l = sps.bit_depth_luma_minus8 + 8
    bd_c = sps.bit_depth_chroma_minus8 + 8
    fs = job.fs
    w, h = fs.w, fs.h
    cfi = sps.chroma_format_idc
    cw_shift = 1 if cfi in (1, 2) else 0
    ch_shift = 1 if cfi == 1 else 0
    h_scu_max = (h + 3) >> 2
    cod = np.zeros((fs.h_scu, fs.w_scu), dtype=np.uint8)

    def filter_edge_col(xpel, ys0, ys1, xs_param, do_luma, do_chroma):
        """Filter edge at column xpel for SCU rows [ys0, ys1); strengths
        come from the SCU column xs_param (the right-side block)."""
        for ys in range(ys0, min(ys1, h_scu_max)):
            st = int(job.db_ver_y[ys, xs_param]) if do_luma else 0
            if st:
                yp = ys << 2
                rows = slice(yp, yp + min(4, h - yp))
                A, B, C, D = (y_plane[rows, xpel - 2], y_plane[rows, xpel - 1],
                              y_plane[rows, xpel], y_plane[rows, xpel + 1])
                A, B, C, D = deblock_luma_edge(A, B, C, D, st, bd_l)
                y_plane[rows, xpel - 2] = A
                y_plane[rows, xpel - 1] = B
                y_plane[rows, xpel] = C
                y_plane[rows, xpel + 1] = D
            if cfi and do_chroma:
                st_u = int(job.db_ver_u[ys, xs_param])
                st_v = int(job.db_ver_v[ys, xs_param])
                if st_u or st_v:
                    xc = xpel >> cw_shift
                    yp = (ys << 2) >> ch_shift
                    rows = slice(yp, yp + (4 >> ch_shift))
                    if st_u:
                        A, B, C, D = (u_plane[rows, xc - 2],
                                      u_plane[rows, xc - 1],
                                      u_plane[rows, xc], u_plane[rows, xc + 1])
                        B, C = deblock_chroma_edge(A, B, C, D, st_u, bd_c)
                        u_plane[rows, xc - 1] = B
                        u_plane[rows, xc] = C
                    if st_v:
                        A, B, C, D = (v_plane[rows, xc - 2],
                                      v_plane[rows, xc - 1],
                                      v_plane[rows, xc], v_plane[rows, xc + 1])
                        B, C = deblock_chroma_edge(A, B, C, D, st_v, bd_c)
                        v_plane[rows, xc - 1] = B
                        v_plane[rows, xc] = C

    for i, do_luma, do_chroma in _cu_deblock_order(fs):
        x0, y0 = fs.cu_x[i], fs.cu_y[i]
        cuw = 1 << fs.cu_log2w[i]
        cuh = 1 << fs.cu_log2h[i]
        x_scu, y_scu = x0 >> 2, y0 >> 2
        scuw, scuh = cuw >> 2, cuh >> 2
        ys0, ys1 = y_scu, y_scu + scuh
        if x0 > 0 and x0 < w and cod[y_scu, x_scu - 1]:
            filter_edge_col(x0, ys0, ys1, x_scu, do_luma, do_chroma)
        if x0 + cuw < w and x_scu + scuw < fs.w_scu and \
                cod[y_scu, x_scu + scuw]:
            filter_edge_col(x0 + cuw, ys0, ys1, x_scu + scuw,
                            do_luma, do_chroma)
        cod[y_scu:y_scu + scuh, x_scu:x_scu + scuw] = 1
