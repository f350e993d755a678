"""Bit-exact numpy oracle for the Main-profile pixel tools.

Mirrors the normative integer arithmetic of the Main-profile kernels
(ref: src_main/xevdm_ipred.c, src_base/xevd_ipred.c angular/plane/bi,
src_main/xevdm_itdq.c, src_main/xevdm_mc.c, src_main/xevdm_df.c,
src_main/xevdm_alf.c, src_main/xevdm_dra.c).  The JAX kernels are validated
against these functions; this backend also runs the full Main decode on host
for conformance work.
"""
from __future__ import annotations

import numpy as np

from .. import tables as T

LR_00, LR_10, LR_01, LR_11 = 0, 1, 2, 3

# 1/(w+1) ~= LUT_SIZE_PLUS1[log2 w] >> 12 (ref: src_base/xevd_ipred.c:108)
LUT_SIZE_PLUS1 = [2048, 1365, 819, 455, 241, 124, 63, 32]


class NbrM:
    """Main-profile neighbor arrays with C-style signed indexing
    (ref: src_main/xevdm_ipred.c:39-148).

    left: [-2, w+h), up: [-h, w+h), right: [-2, w+h).
    """

    __slots__ = ("left", "up", "right", "w", "h")

    def __init__(self, w, h):
        self.w, self.h = w, h
        self.left = np.zeros(2 + w + h, np.int32)
        self.up = np.zeros(h + w + h, np.int32)
        self.right = np.zeros(2 + w + h, np.int32)

    # C-pointer views: v[k] == buffer[offset + k]
    def le(self, k):
        return self.left[2 + k]

    def u(self, k):
        return self.up[self.h + k]


def build_nbr_m(rec: np.ndarray, x: int, y: int, cuw: int, cuh: int,
                unit: int, up_mask: int, upext_mask: int, left_mask: int,
                right_mask: int, corner: int, bit_depth: int) -> NbrM:
    """Mirror of xevdm_get_nbr (ref: src_main/xevdm_ipred.c:39-148).

    Masks are per-SCU-unit availability bits computed by the derive pass;
    `unit` = samples per unit (4 luma, 2 chroma 4:2:0).
    """
    nb = NbrM(cuw, cuh)
    H, W = rec.shape
    mid = 1 << (bit_depth - 1)
    n_units = (cuw + cuh) // unit
    scuh = cuh // unit
    up = nb.up
    ou = cuh  # up offset
    le = nb.left
    ri = nb.right

    # top-left corner + top row seed (up[-1])
    if corner:
        # C copies cuw pels from src[-1]; all but up[-1] are overwritten below
        up[ou - 1] = rec[y - 1, x - 1]
    else:
        up[ou - 1] = mid

    # top row (+ top-right extension): scuw+scuh units
    for i in range(n_units):
        if (up_mask >> i) & 1:
            up[ou + i * unit:ou + (i + 1) * unit] = \
                rec[y - 1, x + i * unit:x + (i + 1) * unit]
        else:
            up[ou + i * unit:ou + (i + 1) * unit] = up[ou + i * unit - 1]

    # top-left extension (scuh units leftwards) or replicate
    if x > 0:
        for i in range(scuh):
            if (upext_mask >> i) & 1:
                up[ou - (i + 1) * unit:ou - i * unit] = \
                    rec[y - 1, x - (i + 1) * unit:x - i * unit]
            else:
                up[ou - (i + 1) * unit:ou - i * unit] = up[ou - i * unit]
    else:
        up[0:ou] = up[ou]

    # left column
    le[2 - 1] = up[ou - 1]
    for i in range(n_units):
        if (left_mask >> i) & 1:
            le[2 + i * unit:2 + (i + 1) * unit] = \
                rec[y + i * unit:y + (i + 1) * unit, x - 1]
        else:
            le[2 + i * unit:2 + (i + 1) * unit] = le[2 + i * unit - 1]
    le[0] = le[1]

    # right column
    ri[2 - 1] = up[ou + cuw]
    for i in range(n_units):
        if (right_mask >> i) & 1:
            ri[2 + i * unit:2 + (i + 1) * unit] = \
                rec[y + i * unit:y + (i + 1) * unit, x + cuw]
        else:
            ri[2 + i * unit:2 + (i + 1) * unit] = ri[2 + i * unit - 1]
    ri[0] = ri[1]
    return nb


def _get_dc(numerator: int, w: int, h: int) -> int:
    """(ref: src_base/xevd_ipred.c:124-144)"""
    log2_w = int(T.TBL_LOG2[w])
    log2_h = int(T.TBL_LOG2[h])
    basic_shift = min(log2_w, log2_h)
    log2_asp = abs(log2_w - log2_h)
    return (numerator * LUT_SIZE_PLUS1[log2_asp]) >> (basic_shift + 12)


def _ipred_dc_m(le, up, ri, avail_lr, w, h):
    """(ref: src_main/xevdm_ipred.c:198-229)"""
    if avail_lr == LR_11:
        dc = int(le[:h].sum()) + int(ri[:h].sum()) + int(up[:w].sum())
        dc = _get_dc(dc + ((w + h + h) >> 1), w, h << 1)
    elif avail_lr == LR_01:
        dc = int(ri[:h].sum()) + int(up[:w].sum())
        dc = _get_dc(dc + ((w + h) >> 1), w, h)
    else:
        dc = int(le[:h].sum()) + int(up[:w].sum())
        dc = _get_dc(dc + ((w + h) >> 1), w, h)
    return np.full((h, w), dc, np.int32)


def _ipred_hor_m(le, up, ri, avail_lr, w, h):
    """(ref: src_main/xevdm_ipred.c:153-196)"""
    if avail_lr == LR_11:
        multi_w = LUT_SIZE_PLUS1[int(T.TBL_LOG2[w])]
        jj = np.arange(w)[None, :]
        vle = le[:h, None].astype(np.int64)
        vri = ri[:h, None].astype(np.int64)
        return (((vle * (w - jj) + vri * (jj + 1) + (w >> 1)) * multi_w)
                >> 12).astype(np.int32)
    if avail_lr == LR_01:
        return np.broadcast_to(ri[:h, None], (h, w)).astype(np.int32)
    return np.broadcast_to(le[:h, None], (h, w)).astype(np.int32)


def _ipred_vert(up, w, h):
    return np.broadcast_to(up[:w], (h, w)).astype(np.int32)


def _ipred_plane(nb: NbrM, avail_lr, w, h, bit_depth):
    """(ref: src_base/xevd_ipred.c:163-249).  Uses C-style signed indexing
    (coef sums reach index -1), so index through the full nb buffers."""
    ou, ol = nb.h, 2
    up = lambda k: int(nb.up[ou + k])
    le = lambda k: int(nb.left[ol + k])
    ri = lambda k: int(nb.right[ol + k])
    w2, h2 = w >> 1, h >> 1
    ib_mult = [13, 17, 5, 11, 23, 47]
    ib_shift = [7, 10, 11, 15, 19, 23]
    lg = T.TBL_LOG2
    idx_w = max(int(lg[w]) - 2, 0)
    idx_h = max(int(lg[h]) - 2, 0)
    im_h, is_h = ib_mult[idx_w], ib_shift[idx_w]
    im_v, is_v = ib_mult[idx_h], ib_shift[idx_h]
    out = np.zeros((h, w), np.int32)
    if avail_lr in (LR_01, LR_11):
        coef_h = sum(x * (up(w2 - x) - up(w2 + x))
                     for x in range(1, w2 + 1))
        coef_v = sum(y_ * (ri(h2 - 1 + y_) - ri(h2 - 1 - y_))
                     for y_ in range(1, h2 + 1))
        a = (ri(h - 1) + up(0)) << 4
        b = ((coef_h << 5) * im_h + (1 << (is_h - 1))) >> is_h
        c = ((coef_v << 5) * im_v + (1 << (is_v - 1))) >> is_v
        temp = a - (h2 - 1) * c - (w2 - 1) * b + 16
        # dst[x] filled right-to-left with temp2 += b
        jj = np.arange(w - 1, -1, -1)
        steps = np.empty(w, np.int64)
        steps[jj] = np.arange(w)
        for y_ in range(h):
            out[y_] = np.clip((temp + steps * b) >> 5, 0,
                              (1 << bit_depth) - 1)
            temp += c
    else:
        coef_h = sum(x * (up(w2 - 1 + x) - up(w2 - 1 - x))
                     for x in range(1, w2 + 1))
        coef_v = sum(y_ * (le(h2 - 1 + y_) - le(h2 - 1 - y_))
                     for y_ in range(1, h2 + 1))
        a = (le(h - 1) + up(w - 1)) << 4
        b = ((coef_h << 5) * im_h + (1 << (is_h - 1))) >> is_h
        c = ((coef_v << 5) * im_v + (1 << (is_v - 1))) >> is_v
        temp = a - (h2 - 1) * c - (w2 - 1) * b + 16
        steps = np.arange(w, dtype=np.int64)
        for y_ in range(h):
            out[y_] = np.clip((temp + steps * b) >> 5, 0,
                              (1 << bit_depth) - 1)
            temp += c
    return out


def _ipred_bi(nb: NbrM, avail_lr, w, h, bit_depth):
    """(ref: src_base/xevd_ipred.c:251-368). Uses C-offset views for the
    [-1]/[w]/[h] accesses."""
    le = nb.left[2:2 + h].astype(np.int64)
    up = nb.up[nb.h:nb.h + w].astype(np.int64)
    ri = nb.right[2:2 + h].astype(np.int64)
    ish_x = int(T.TBL_LOG2[w])
    ish_y = int(T.TBL_LOG2[h])
    ish = min(ish_x, ish_y)
    ish_xy = ish_x + ish_y + 1
    offset = 1 << (ish_x + ish_y)
    tbl_wc = [-1, 341, 205, 114, 60, 31]
    wc = tbl_wc[abs(ish_x - ish_y)]
    out = np.zeros((h, w), np.int64)
    maxv = (1 << bit_depth) - 1
    if avail_lr == LR_11:
        multi_w = LUT_SIZE_PLUS1[ish_x]
        jj = np.arange(w)[None, :]
        dst_tmp = ((le[:, None] * (w - jj) + ri[:, None] * (jj + 1)
                    + (w >> 1)) * multi_w) >> 12
        yy = np.arange(h)[:, None]
        tmp = (up[None, :] * (h - 1 - yy) + dst_tmp[h - 1][None, :] * (yy + 1)
               + (h >> 1)) >> ish_y
        out = (dst_tmp + tmp + 1) >> 1
    elif avail_lr == LR_01:
        a = int(nb.up[nb.h - 1])
        b = int(nb.right[2 + h])
        c = ((a + b + 1) >> 1 if w == h else
             (((a << ish_x) + (b << ish_y)) * wc + (1 << (ish + 9)))
             >> (ish + 10))
        wt = (c << 1) - a - b
        up_s = (b - up)          # 'up[x]' delta
        ref_up = up << ish_y
        ri_s = a - ri
        ref_ri = ri << ish_x
        wy = np.arange(h, dtype=np.int64) * wt
        # per row: predx starts at ref_ri[y], accumulates ri_s per step
        # (x from w-1 down to 0); ref_up[x] += up_s[x] per row processed
        kk = np.arange(1, w + 1, dtype=np.int64)  # steps for predx
        for y_ in range(h):
            predx = ref_ri[y_] + kk * ri_s[y_]           # at x=w-1..0
            ref_up = ref_up + up_s
            # predx[k] / wxy step k correspond to x = w-1-k
            px = np.empty(w, np.int64)
            px[w - 1 - np.arange(w)] = predx
            wx = np.empty(w, np.int64)
            wx[w - 1 - np.arange(w)] = np.arange(w) * wy[y_]
            out[y_] = np.clip(
                ((px << ish_y) + (ref_up << ish_x) + wx + offset) >> ish_xy,
                0, maxv)
    else:
        a = int(nb.up[nb.h + w])
        b = int(nb.left[2 + h])
        c = ((a + b + 1) >> 1 if w == h else
             (((a << ish_x) + (b << ish_y)) * wc + (1 << (ish + 9)))
             >> (ish + 10))
        wt = (c << 1) - a - b
        up_s = b - up
        ref_up = up << ish_y
        le_s = a - le
        ref_le = le << ish_x
        wy = np.arange(h, dtype=np.int64) * wt
        for y_ in range(h):
            px = ref_le[y_] + np.arange(1, w + 1, dtype=np.int64) * le_s[y_]
            ref_up = ref_up + up_s
            wx = np.arange(w, dtype=np.int64) * wy[y_]
            out[y_] = np.clip(
                ((px << ish_y) + (ref_up << ish_x) + wx + offset) >> ish_xy,
                0, maxv)
    return out.astype(np.int32)


_ANG_CACHE = {}


def _ang_geometry(w: int, h: int, ipm: int, avail_lr: int):
    """Pixel-independent gather geometry for angular prediction
    (ref: src_base/xevd_ipred.c:377-585).  Returns (sel, idx4, filt4):
    sel[h,w] in {0:up,1:left,2:right}, idx4[h,w,4] clipped positions,
    filt4[h,w,4] ADI filter taps."""
    key = (w, h, ipm, avail_lr)
    hit = _ANG_CACHE.get(key)
    if hit is not None:
        return hit
    pos_max = w + h - 1
    pos_min = -1
    mt = T.IPRED_DXDY[ipm]
    dxy = -1 if (ipm > T.IPD_HOR or ipm < T.IPD_VER) else 1
    sel = np.zeros((h, w), np.int8)
    idx4 = np.zeros((h, w, 4), np.int32)
    filt4 = np.zeros((h, w, 4), np.int64)

    def get_ref_pos(m, d_in):
        d_out = (d_in * m) >> 10
        offset = ((d_in * m) >> 5) - (d_out << 5)
        return int(d_out), int(offset)

    for j in range(h):
        for i in range(w):
            if ipm < T.IPD_VER:
                t_dx, offset = get_ref_pos(mt[0], j + 1)
                if avail_lr in (LR_01, LR_11) and i >= (w - t_dx):
                    t_dy, offset = get_ref_pos(mt[1], w - i)
                    x_, y_, refpos = w, j - t_dy, 2
                else:
                    x_, y_, refpos = i + t_dx, -1, 0
            elif ipm > T.IPD_HOR:
                if avail_lr in (LR_01, LR_11):
                    t_dy, offset = get_ref_pos(mt[1], w - i)
                    if j < t_dy:
                        t_dx, offset = get_ref_pos(mt[0], w - i)
                        x_, y_, refpos = i + t_dx, -1, 0
                    else:
                        x_, y_, refpos = w, j - t_dy, 2
                else:
                    t_dy, offset = get_ref_pos(mt[1], i + 1)
                    x_, y_, refpos = -1, j + t_dy, 1
            else:
                t_dy, offset = get_ref_pos(mt[1], i + 1)
                if j < t_dy:
                    t_dx, offset = get_ref_pos(mt[0], j + 1)
                    x_, y_, refpos = i - t_dx, -1, 0
                else:
                    if avail_lr == LR_01:
                        t_dy, offset = get_ref_pos(mt[1], w - i)
                        x_, y_, refpos = w, j + t_dy, 2
                    else:
                        x_, y_, refpos = -1, j - t_dy, 1

            if refpos == 0:
                p = x_
                if dxy < 0:
                    pn_n1, pn, pn_p2 = x_ - 1, x_ + 1, x_ + 2
                else:
                    pn_n1, pn, pn_p2 = x_ + 1, x_ - 1, x_ - 2
            elif refpos == 1:
                p = y_
                if dxy < 0:
                    pn_n1, pn, pn_p2 = y_ - 1, y_ + 1, y_ + 2
                else:
                    pn_n1, pn, pn_p2 = y_ + 1, y_ - 1, y_ - 2
            else:
                p = y_
                if dxy > 0:
                    pn_n1, pn, pn_p2 = y_ - 1, y_ + 1, y_ + 2
                else:
                    pn_n1, pn, pn_p2 = y_ + 1, y_ - 1, y_ - 2

            clip = lambda v: max(min(v, pos_max), pos_min)
            sel[j, i] = refpos
            idx4[j, i] = (clip(pn_n1), clip(p), clip(pn), clip(pn_p2))
            filt4[j, i] = T.IPRED_ADI[offset]
    _ANG_CACHE[key] = (sel, idx4, filt4)
    return sel, idx4, filt4


def _ipred_ang(nb: NbrM, avail_lr, ipm, w, h, bit_depth):
    """4-tap angular prediction via cached gather geometry."""
    sel, idx4, filt4 = _ang_geometry(w, h, ipm, avail_lr)
    # stack refs with +1 offset so index -1 maps to 0
    n = w + h + 1
    refs = np.zeros((3, n), np.int64)
    refs[0] = nb.up[nb.h - 1:nb.h + w + h]
    refs[1] = nb.left[1:2 + w + h]
    refs[2] = nb.right[1:2 + w + h]
    v = refs[sel[..., None], idx4 + 1]          # [h,w,4]
    out = (v * filt4).sum(-1)
    out = (out + 64) >> 7                        # ADI_4T offset/bits
    return np.clip(out, 0, (1 << bit_depth) - 1).astype(np.int32)


def ipred_main(nb: NbrM, avail_lr: int, ipm: int, w: int, h: int,
               bit_depth: int) -> np.ndarray:
    """EIPD luma prediction (ref: src_main/xevdm_ipred.c:241-265)."""
    le = nb.left[2:].astype(np.int64)
    up = nb.up[nb.h:].astype(np.int64)
    ri = nb.right[2:].astype(np.int64)
    if ipm == T.IPD_VER:
        return _ipred_vert(up, w, h)
    if ipm == T.IPD_HOR:
        return _ipred_hor_m(le, up, ri, avail_lr, w, h)
    if ipm == T.IPD_DC:
        return _ipred_dc_m(le, up, ri, avail_lr, w, h)
    if ipm == T.IPD_PLN:
        return _ipred_plane(nb, avail_lr, w, h, bit_depth)
    if ipm == T.IPD_BI:
        return _ipred_bi(nb, avail_lr, w, h, bit_depth)
    return _ipred_ang(nb, avail_lr, ipm, w, h, bit_depth)


def ipred_uv_main(nb: NbrM, avail_lr: int, ipm_c: int, ipm: int, w: int,
                  h: int, bit_depth: int) -> np.ndarray:
    """EIPD chroma prediction (ref: src_main/xevdm_ipred.c:267-305)."""
    if ipm_c == T.IPD_DM_C and ipm in (T.IPD_VER, T.IPD_HOR, T.IPD_DC,
                                       T.IPD_BI):
        ipm_c = {T.IPD_VER: T.IPD_VER_C, T.IPD_HOR: T.IPD_HOR_C,
                 T.IPD_DC: T.IPD_DC_C, T.IPD_BI: T.IPD_BI_C}[ipm]
    le = nb.left[2:].astype(np.int64)
    up = nb.up[nb.h:].astype(np.int64)
    ri = nb.right[2:].astype(np.int64)
    if ipm_c == T.IPD_DM_C:
        if ipm == T.IPD_PLN:
            return _ipred_plane(nb, avail_lr, w, h, bit_depth)
        return _ipred_ang(nb, avail_lr, ipm, w, h, bit_depth)
    if ipm_c == T.IPD_DC_C:
        return _ipred_dc_m(le, up, ri, avail_lr, w, h)
    if ipm_c == T.IPD_HOR_C:
        return _ipred_hor_m(le, up, ri, avail_lr, w, h)
    if ipm_c == T.IPD_VER_C:
        return _ipred_vert(up, w, h)
    if ipm_c == T.IPD_BI_C:
        return _ipred_bi(nb, avail_lr, w, h, bit_depth)
    raise ValueError(f"illegal chroma ipm {ipm_c}")
