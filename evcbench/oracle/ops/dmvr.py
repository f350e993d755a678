"""DMVR: decoder-side motion vector refinement (numpy oracle).

Behavioral reference: src_main/xevdm_mc.c — processDMVR (:1638-1825),
xevd_DMVR_refine/:1293 + xevd_SubPelErrorSrfc/:1373 (5-point SAD pattern +
parametric sub-pel error surface), xevdm_bl_mc_l bilinear pre-interp
(:440-487), prefetch_for_mc + final_paddedMC_forDMVR (:1478-1636) with the
edge-replicated pad buffers, mv_clip/mv_clip_only_one_ref_dmvr.

The refinement runs per 16x16 sub-PU over merge-mode bi CUs whose two
references sit symmetrically around the current POC; the refined MVs feed
the final MC and the stored motion field (TMVP of later frames), while
spatial merge candidates and deblocking keep the unrefined MVs
(ref: xevdm_util.c map_unrefined_mv / MCU_DMVRF).
"""
from __future__ import annotations

import numpy as np

from .. import tables as T

MAX_CU_SIZE = 128
DMVR_SUBCU = 16
ITER = 2                    # DMVR_ITER_COUNT
PAD = 2                     # DMVR_PAD_LENGTH
STRIDE = MAX_CU_SIZE + 7 + ITER * 2      # PAD_BUFFER_STRIDE

BL_COEFF = np.array([[64 - 4 * p, 4 * p] for p in range(16)], np.int64)


def dmvr_condition(sps, poc_c, refp, refi, mv, w, h):
    """apply_DMVR (ref: xevdm_mc.c:1894-1909 + recon-side dmvr_enable)."""
    if refi[0] < 0 or refi[1] < 0:
        return False
    p0 = refp[refi[0]][0].poc
    p1 = refp[refi[1]][1].poc
    if not ((poc_c - p0) * (poc_c - p1) < 0 and
            abs(poc_c - p0) == abs(poc_c - p1)):
        return False
    if p0 == p1 and mv[0][0] == mv[1][0] and mv[0][1] == mv[1][1]:
        return False
    return w >= 8 and h >= 8


def _mv_clip_one(x, y, pic_w, pic_h, w, h, mv):
    """(ref: mv_clip_only_one_ref_dmvr)"""
    x4, y4, w4, h4 = x << 2, y << 2, w << 2, h << 2
    lo = -(MAX_CU_SIZE << 2)
    hix = (pic_w - 1 + MAX_CU_SIZE) << 2
    hiy = (pic_h - 1 + MAX_CU_SIZE) << 2
    ox, oy = int(mv[0]), int(mv[1])
    clip = False
    if x4 + ox < lo:
        clip = True
        ox = lo - x4
    if y4 + oy < lo:
        clip = True
        oy = lo - y4
    if x4 + ox + w4 - 4 > hix:
        clip = True
        ox = hix - x4 - w4 + 4
    if y4 + oy + h4 - 4 > hiy:
        clip = True
        oy = hiy - y4 - h4 + 4
    return (ox, oy), clip


def _bl_mc(plane, pad, gx16, gy16, w, h, bd):
    """Bilinear 2-tap luma MC (ref: xevdm_bl_mc_l_{00,n0,0n,nn},
    xevdm_mc.c:358-487).  The 1-D branches truncate (`>> 6`, MAC_ADD_N0
    == 0); only the 2-D branch carries shift1/shift2 rounding."""
    dx, dy = gx16 & 15, gy16 & 15
    ix = (gx16 >> 4) + pad
    iy = (gy16 >> 4) + pad
    win = plane[iy:iy + h + 1, ix:ix + w + 1].astype(np.int64)
    maxv = (1 << bd) - 1
    if dx == 0 and dy == 0:
        return win[:h, :w].astype(np.int32)
    if dy == 0:
        c = BL_COEFF[dx]
        pt = (c[0] * win[:h, :w] + c[1] * win[:h, 1:w + 1]) >> 6
        return np.clip(pt, 0, maxv).astype(np.int32)
    if dx == 0:
        c = BL_COEFF[dy]
        pt = (c[0] * win[:h, :w] + c[1] * win[1:h + 1, :w]) >> 6
        return np.clip(pt, 0, maxv).astype(np.int32)
    shift1 = min(4, bd - 8)
    shift2 = max(8, 20 - bd)
    off2 = 1 << (shift2 - 1)
    c = BL_COEFF[dx]
    b = (c[0] * win[:, :w] + c[1] * win[:, 1:w + 1]) >> shift1
    c = BL_COEFF[dy]
    pt = (c[0] * b[:h] + c[1] * b[1:h + 1] + off2) >> shift2
    return np.clip(pt, 0, maxv).astype(np.int32)


def _sad(a, b):
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).sum())


def _div_q7(n, d):
    """(ref: div_for_maxq7)"""
    sign = n < 0
    if sign:
        n = -n
    q = 0
    d = d << 3
    if n >= d:
        n -= d
        q += 1
    q <<= 1
    d >>= 1
    if n >= d:
        n -= d
        q += 1
    q <<= 1
    if n >= (d >> 1):
        q += 1
    return -q if sign else q


def _subpel_srfc(sad):
    """(ref: xevd_SubPelErrorSrfc)"""
    out = [0, 0]
    num = (sad[1] - sad[3]) << 4
    den = sad[1] + sad[3] - (sad[0] << 1)
    if den != 0:
        if sad[1] != sad[0] and sad[3] != sad[0]:
            out[0] = _div_q7(num, den)
        else:
            out[0] = -8 if sad[1] == sad[0] else 8
    num = (sad[2] - sad[4]) << 4
    den = sad[2] + sad[4] - (sad[0] << 1)
    if den != 0:
        if sad[2] != sad[0] and sad[4] != sad[0]:
            out[1] = _div_q7(num, den)
        else:
            out[1] = -8 if sad[2] == sad[0] else 8
    return out


def _refine(bl0, bl1, sy, sx, dx_, dy_):
    """One sub-PU full refinement (ref: processDMVR:1711-1768 + refine).
    bl0/bl1: the (h+4)x(w+4) bilinear planes; (sy, sx): sub-PU offset
    inside the CU (plus ITER border).  Returns total_delta (1/16)."""
    total = [0, 0]
    min_cost = 1 << 60
    arr = [0] * 5   # center, bottom, top, right, left order per SAD_*:
    # SAD enum: BOTTOM=0? reference: SAD_BOTTOM..SAD_TOP_LEFT with
    # searchOffsets {0,1},{0,-1},{1,0},{-1,0},{tl}; SAD_CENTER separate.
    not_zero = True
    SAD_CENTER = 0

    def blk(b, oy, ox):
        return b[sy + oy:sy + oy + dy_, sx + ox:sx + ox + dx_]

    cost_arr = {}
    for it in range(ITER):
        off = [0, 0, 0, 0, 0, 0]
        # search offsets: bottom(0,1) top(0,-1) right(1,0) left(-1,0) tl
        sox = [0, 0, 1, -1, 0]
        soy = [1, -1, 0, 0, 0]
        if it == 0:
            min_cost = _sad(blk(bl0, total[1], total[0]),
                            blk(bl1, -total[1], -total[0]))
        if (it > 0 and min_cost == 0) or (it == 0 and min_cost < dy_ * dx_):
            not_zero = False
            break
        cost_arr = {-1: min_cost}
        delta = [0, 0]
        for idx in range(5):
            if idx == 4:
                sox[4] = 1 if cost_arr[2] <= cost_arr[3] else -1
                soy[4] = 1 if cost_arr[0] <= cost_arr[1] else -1
            c = _sad(blk(bl0, total[1] + soy[idx], total[0] + sox[idx]),
                     blk(bl1, -total[1] - soy[idx], -total[0] - sox[idx]))
            cost_arr[idx] = c
            if c < min_cost:
                min_cost = c
                delta = [sox[idx], soy[idx]]
        if delta == [0, 0]:
            break
        total[0] += delta[0]
        total[1] += delta[1]

    tdx, tdy = total[0] << 4, total[1] << 4
    if not_zero and min_cost == cost_arr.get(-1, -1):
        sadbuf = [cost_arr[-1], cost_arr[3], cost_arr[1], cost_arr[2],
                  cost_arr[0]]
        dmv = _subpel_srfc(sadbuf)
        tdx += dmv[0]
        tdy += dmv[1]
    return tdx, tdy


def _prefetch(pic, x, y, pu_x, pu_y, pu_w, pu_h, pic_w, pic_h, w, h, mv_t,
              cfi):
    """Padded per-list reference windows (ref: prefetch_for_mc)."""
    cw_s = 1 if cfi in (1, 2) else 0
    ch_s = 1 if cfi == 1 else 0
    out = {}
    tlx, tly = pu_x - x, pu_y - y
    gx = ((pu_x << 2) + mv_t[0]) << 2
    gy = ((pu_y << 2) + mv_t[1]) << 2
    # luma: (w+8)x(h+8) window from int pos - 3, then 2-px edge pad
    pad = pic.pad_l
    ix = (gx >> 4) - 3 + pad
    iy = (gy >> 4) - 3 + pad
    buf = np.zeros((STRIDE, STRIDE), np.int32)
    oy = ITER + tly
    ox = ITER + tlx
    buf[oy:oy + pu_h + 8, ox:ox + pu_w + 8] = \
        pic.y[iy:iy + pu_h + 8, ix:ix + pu_w + 8]
    _edge_pad(buf, oy, ox, pu_w + 7, pu_h + 7, PAD)
    out[0] = buf
    if cfi:
        pad_c = pic.pad_c
        c_w, c_h = pu_w >> cw_s, pu_h >> ch_s
        for ci, plane in ((1, pic.u), (2, pic.v)):
            ix = (gx >> 5) - 1 + pad_c
            iy = (gy >> 5) - 1 + pad_c
            buf = np.zeros((STRIDE, STRIDE), np.int32)
            oy = ITER + (tly >> ch_s)
            ox = ITER + (tlx >> cw_s)
            buf[oy:oy + c_h + 4, ox:ox + c_w + 4] = \
                plane[iy:iy + c_h + 4, ix:ix + c_w + 4]
            _edge_pad(buf, oy, ox, c_w + 3, c_h + 3, PAD >> 1)
            out[ci] = buf
    return out


def _edge_pad(buf, oy, ox, w, h, p):
    """(ref: padding) replicate w x h region at (oy, ox) outward by p."""
    buf[oy:oy + h, ox - p:ox] = buf[oy:oy + h, ox:ox + 1]
    buf[oy:oy + h, ox + w:ox + w + p] = buf[oy:oy + h, ox + w - 1:ox + w]
    buf[oy - p:oy, ox - p:ox + w + p] = buf[oy, ox - p:ox + w + p]
    buf[oy + h:oy + h + p, ox - p:ox + w + p] = \
        buf[oy + h - 1, ox - p:ox + w + p]


def _mc8_buf(buf, base_y, base_x, gx, gy, w, h, bd, taps):
    """8-tap MC on the padded buffer; (base_y, base_x) = the position in
    the buffer matching integer position gx>>4, gy>>4; fractions from
    gx/gy (ref: xevd_mc_dmvr_l_* kernels)."""
    dx, dy = gx & 15, gy & 15
    shift1 = min(4, bd - 8)
    shift2 = max(8, 20 - bd)
    off2 = 1 << (shift2 - 1)
    maxv = (1 << bd) - 1
    if dx == 0 and dy == 0:
        return np.clip(buf[base_y:base_y + h, base_x:base_x + w], 0, maxv)
    if dx != 0 and dy == 0:
        win = buf[base_y:base_y + h,
                  base_x - 3:base_x + w + 4].astype(np.int64)
        c = taps[dx]
        acc = sum(int(c[k]) * win[:, k:k + w] for k in range(8))
        return np.clip(acc >> 6, 0, maxv)
    if dx == 0 and dy != 0:
        win = buf[base_y - 3:base_y + h + 4,
                  base_x:base_x + w].astype(np.int64)
        c = taps[dy]
        acc = sum(int(c[k]) * win[k:k + h, :] for k in range(8))
        return np.clip(acc >> 6, 0, maxv)
    win = buf[base_y - 3:base_y + h + 4,
              base_x - 3:base_x + w + 7].astype(np.int64)
    c = taps[dx]
    b = sum(int(c[k]) * win[:, k:k + w] for k in range(8)) >> shift1
    c = taps[dy]
    acc = sum(int(c[k]) * b[k:k + h, :] for k in range(8))
    return np.clip((acc + off2) >> shift2, 0, maxv)


def _mc4_buf(buf, base_y, base_x, gx, gy, w, h, bd, taps):
    """4-tap chroma MC on the padded buffer (ref: xevd_mc_dmvr_c_*)."""
    dx, dy = gx & 31, gy & 31
    shift1 = min(4, bd - 8)
    shift2 = max(8, 20 - bd)
    off2 = 1 << (shift2 - 1)
    maxv = (1 << bd) - 1
    if dx == 0 and dy == 0:
        return np.clip(buf[base_y:base_y + h, base_x:base_x + w], 0, maxv)
    if dx != 0 and dy == 0:
        win = buf[base_y:base_y + h,
                  base_x - 1:base_x + w + 2].astype(np.int64)
        c = taps[dx]
        acc = sum(int(c[k]) * win[:, k:k + w] for k in range(4))
        return np.clip(acc >> 6, 0, maxv)
    if dx == 0 and dy != 0:
        win = buf[base_y - 1:base_y + h + 2,
                  base_x:base_x + w].astype(np.int64)
        c = taps[dy]
        acc = sum(int(c[k]) * win[k:k + h, :] for k in range(4))
        return np.clip(acc >> 6, 0, maxv)
    win = buf[base_y - 1:base_y + h + 2,
              base_x - 1:base_x + w + 3].astype(np.int64)
    c = taps[dx]
    b = sum(int(c[k]) * win[:, k:k + w] for k in range(4)) >> shift1
    c = taps[dy]
    acc = sum(int(c[k]) * b[k:k + h, :] for k in range(4))
    return np.clip((acc + off2) >> shift2, 0, maxv)


def dmvr_refine_cu(x, y, pic_w, pic_h, w, h, refi, mv, refp, bd):
    """Refinement only: bilinear pre-interp + per-sub-PU search.
    Returns int64 [n_sy, n_sx, 2, 2] refined MVs at 1/16-pel (the final
    MC needs the sub-pel part; the motion field / HMVP store >> 2,
    ref: dmvr_mv)."""
    start = [None, None]
    for l in range(2):
        s_, _ = _mv_clip_one(x, y, pic_w, pic_h, w, h, mv[l])
        start[l] = s_
    stride_ext = w + ITER * 2
    bl = []
    for l in range(2):
        pic = refp[refi[l]][l].pic
        tmx = start[l][0] - (ITER << 2)
        tmy = start[l][1] - (ITER << 2)
        gx = ((x << 2) + tmx) << 2
        gy = ((y << 2) + tmy) << 2
        bl.append(_bl_mc(pic.y, pic.pad_l, gx, gy, stride_ext,
                         h + ITER * 2, bd))
    dy_ = min(h, DMVR_SUBCU)
    dx_ = min(w, DMVR_SUBCU)
    n_sx = w // dx_
    n_sy = h // dy_
    refined = np.zeros((n_sy, n_sx, 2, 2), np.int64)   # 1/16 units
    for sj in range(n_sy):
        for si in range(n_sx):
            tdx, tdy = _refine(bl[0], bl[1], ITER + sj * dy_,
                               ITER + si * dx_, dx_, dy_)
            refined[sj, si, 0] = [(start[0][0] << 2) + tdx,
                                  (start[0][1] << 2) + tdy]
            refined[sj, si, 1] = [(start[1][0] << 2) - tdx,
                                  (start[1][1] << 2) - tdy]
    return refined


def process_dmvr(x, y, pic_w, pic_h, w, h, refi, mv, refp, bd, bd_c, cfi,
                 refined=None):
    """Full DMVR for one CU (ref: processDMVR).  mv: [2][2] unrefined
    quarter-pel.  Returns (pred0, pred1) tuples of (y, u, v) int32 planes
    and refined [n_sub][2][2] quarter-pel MVs with their sub-PU grid."""
    cw_s = 1 if cfi in (1, 2) else 0
    ch_s = 1 if cfi == 1 else 0
    start = [None, None]
    for l in range(2):
        s, _ = _mv_clip_one(x, y, pic_w, pic_h, w, h, mv[l])
        start[l] = s
    stride_ext = w + ITER * 2

    if refined is None:
        # bilinear pre-interpolation, (w+4)x(h+4) per list
        bl = []
        for l in range(2):
            pic = refp[refi[l]][l].pic
            tmx = start[l][0] - (ITER << 2)
            tmy = start[l][1] - (ITER << 2)
            gx = ((x << 2) + tmx) << 2
            gy = ((y << 2) + tmy) << 2
            bl.append(_bl_mc(pic.y, pic.pad_l, gx, gy, stride_ext,
                             h + ITER * 2, bd))

    dy_ = min(h, DMVR_SUBCU)
    dx_ = min(w, DMVR_SUBCU)
    n_sx = w // dx_
    n_sy = h // dy_
    if refined is None:
        refined = np.zeros((n_sy, n_sx, 2, 2), np.int64)   # 1/16 units
        for sj in range(n_sy):
            for si in range(n_sx):
                tdx, tdy = _refine(bl[0], bl[1], ITER + sj * dy_,
                                   ITER + si * dx_, dx_, dy_)
                refined[sj, si, 0] = [(start[0][0] << 2) + tdx,
                                      (start[0][1] << 2) + tdy]
                refined[sj, si, 1] = [(start[1][0] << 2) - tdx,
                                      (start[1][1] << 2) - tdy]

    # final padded MC per sub-PU per list
    taps_l = T.MC_L_COEFF_MAIN
    taps_c = T.MC_C_COEFF_MAIN
    preds = []
    for l in range(2):
        pic = refp[refi[l]][l].pic
        py = np.zeros((h, w), np.int32)
        pu = pv = None
        if cfi:
            pu = np.zeros((h >> ch_s, w >> cw_s), np.int32)
            pv = np.zeros_like(pu)
        for sj in range(n_sy):
            for si in range(n_sx):
                pux, puy = x + si * dx_, y + sj * dy_
                bufs = _prefetch(pic, x, y, pux, puy, dx_, dy_, pic_w,
                                 pic_h, w, h, start[l], cfi)
                rmv = refined[sj, si, l]
                tmp = (int(rmv[0]) >> 2, int(rmv[1]) >> 2)
                mvt, clip = _mv_clip_one(pux, puy, pic_w, pic_h, dx_, dy_,
                                         tmp)
                if clip:
                    gx = (pux << 4) + (mvt[0] << 2)
                    gy = (puy << 4) + (mvt[1] << 2)
                    d_xl = (mvt[0] >> 2) - (start[l][0] >> 2)
                    d_yl = (mvt[1] >> 2) - (start[l][1] >> 2)
                    d_xc = (mvt[0] >> 3) - (start[l][0] >> 3)
                    d_yc = (mvt[1] >> 3) - (start[l][1] >> 3)
                else:
                    gx = (pux << 4) + int(rmv[0])
                    gy = (puy << 4) + int(rmv[1])
                    d_xl = (int(rmv[0]) >> 4) - (start[l][0] >> 2)
                    d_yl = (int(rmv[1]) >> 4) - (start[l][1] >> 2)
                    d_xc = (int(rmv[0]) >> 5) - (start[l][0] >> 3)
                    d_yc = (int(rmv[1]) >> 5) - (start[l][1] >> 3)
                tlx, tly = pux - x, puy - y
                base_y = ITER + 3 + d_yl + tly
                base_x = ITER + 3 + d_xl + tlx
                py[sj * dy_:sj * dy_ + dy_, si * dx_:si * dx_ + dx_] = \
                    _mc8_buf(bufs[0], base_y, base_x, gx, gy, dx_, dy_,
                             bd, taps_l)
                if cfi:
                    base_y = ITER + 1 + d_yc + (tly >> ch_s)
                    base_x = ITER + 1 + d_xc + (tlx >> cw_s)
                    cyo = (sj * dy_) >> ch_s
                    cxo = (si * dx_) >> cw_s
                    pu[cyo:cyo + (dy_ >> ch_s),
                       cxo:cxo + (dx_ >> cw_s)] = _mc4_buf(
                        bufs[1], base_y, base_x, gx, gy, dx_ >> cw_s,
                        dy_ >> ch_s, bd_c, taps_c)
                    pv[cyo:cyo + (dy_ >> ch_s),
                       cxo:cxo + (dx_ >> cw_s)] = _mc4_buf(
                        bufs[2], base_y, base_x, gx, gy, dx_ >> cw_s,
                        dy_ >> ch_s, bd_c, taps_c)
        preds.append((py, pu, pv))
    # refined MVs for the motion field, 1/4 units
    ref_q = (refined >> 2).astype(np.int32)
    return preds[0], preds[1], ref_q, dx_, dy_
