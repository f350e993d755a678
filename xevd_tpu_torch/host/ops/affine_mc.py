"""Affine motion compensation (numpy oracle): sub-block translation MC +
the enhanced interpolation filter (EIF).

Behavioral reference: src_main/xevdm_mc.c:2108-2664 — xevdm_affine_mc /
xevdm_affine_mc_lc (:2259), xevdm_eif_mc (:2560+), bilinear kernels and
the 3-tap correction filter, eif_derive_mv_clip_range (:2108).  The
non-EIF block path applies ONE constant MV (the model evaluated at the
first sub-block center) across the whole CU — a reference quirk we
reproduce bit-exactly (ref loop :2233-2256 never advances mv_scale).
"""
from __future__ import annotations

import numpy as np

from .. import tables as T
from ..affine import (derive_affine_subblock_size_bi, mv_rounding,
                      rounding_s32, _model_params)
from . import ref_numpy as RN

MAX_CU_SIZE = 128
MAX_CU_LOG2 = 7
EIF_PREC = 9            # EIF_MV_PRECISION_INTERNAL = 2 + MAX_CU_LOG2
EIF_BILIN = 5           # EIF_MV_PRECISION_BILINEAR

# 32-phase 2-tap bilinear (ref: xevdm_mc.c:178-213)
BL_EIF = np.array([[64 - 2 * p, 2 * p] for p in range(32)], dtype=np.int64)

# mv spread per log2 size 3..7 (ref: xevdm_mc.c:90 g_aff_mvDevBB2_125)
AFF_MV_DEV = [128, 256, 544, 1120, 2272]


def _eif_clip_range(x, y, cuw, cuh, d_hor, d_ver, mv_scale, pic_w, pic_h,
                    range_clip):
    """(ref: eif_derive_mv_clip_range)"""
    max_pic = [(pic_w + MAX_CU_SIZE - x - cuw - 1) << 5,
               (pic_h + MAX_CU_SIZE - y - cuh - 1) << 5]
    min_pic = [(-x - MAX_CU_SIZE) << 5, (-y - MAX_CU_SIZE) << 5]
    max_mv = [0, 0]
    min_mv = [0, 0]
    pos_center = [cuw >> 1, cuh >> 1]
    for c in range(2):
        if not range_clip:
            max_mv[c] = max_pic[c]
            min_mv[c] = min_pic[c]
        else:
            center = mv_scale[c] + d_hor[c] * pos_center[0] \
                + d_ver[c] * pos_center[1]
            center = rounding_s32(center, 4, 0)
            spread = AFF_MV_DEV[int(T.TBL_LOG2[cuw if c == 0 else cuh]) - 3]
            min_mv[c] = center - spread
            max_mv[c] = center + spread
            if min_mv[c] < min_pic[c]:
                min_mv[c] = min_pic[c]
                max_mv[c] = min(max_pic[c], min_pic[c] + 2 * spread)
            elif max_mv[c] > max_pic[c]:
                max_mv[c] = max_pic[c]
                min_mv[c] = max(min_pic[c], max_pic[c] - 2 * spread)
        max_mv[c] = max(-(1 << 17), min((1 << 17) - 1, max_mv[c]))
        min_mv[c] = max(-(1 << 17), min((1 << 17) - 1, min_mv[c]))
    return max_mv, min_mv


def _can_clip_occur(bw, bh, mv0, d_x, d_y, mv_max, mv_min):
    """(ref: can_mv_clipping_occurs)"""
    mv = [mv0[0] - d_x[0] - d_y[0], mv0[1] - d_x[1] - d_y[1]]
    bw, bh = bw + 1, bh + 1
    for c in range(2):
        corners = [mv[c], mv[c] + bw * d_x[c], mv[c] + bh * d_y[c],
                   mv[c] + bw * d_x[c] + bh * d_y[c]]
        for v in corners:
            if (v >> 4) > mv_max[c] or (v >> 4) < mv_min[c]:
                return True
    return False


def _eif_one(plane, pad, px, py, bw, bh, mv0, d_x, d_y, mv_max, mv_min,
             clip_mv, bd):
    """EIF for one component (ref: xevdm_eif_bilinear_* + xevdm_eif_filter).
    plane: padded plane; (px, py): block origin in unpadded coords."""
    # grid of internal-precision MVs at (xx, yy) for xx,yy in -1..bw/bh
    xs = np.arange(-1, bw + 1, dtype=np.int64)
    ys = np.arange(-1, bh + 1, dtype=np.int64)
    tx = mv0[0] + d_x[0] * xs[None, :] + d_y[0] * ys[:, None]
    ty = mv0[1] + d_x[1] * xs[None, :] + d_y[1] * ys[:, None]
    mvx = tx >> (EIF_PREC - EIF_BILIN)
    mvy = ty >> (EIF_PREC - EIF_BILIN)
    if clip_mv:
        mvx = np.clip(mvx, mv_min[0], mv_max[0])
        mvy = np.clip(mvy, mv_min[1], mv_max[1])
    x_int = xs[None, :] + (mvx >> EIF_BILIN)
    y_int = ys[:, None] + (mvy >> EIF_BILIN)
    xf = (mvx & 31).astype(np.int64)
    yf = (mvy & 31).astype(np.int64)

    shift1 = min(4, bd - 8)
    shift2 = max(8, 20 - bd)
    offset2 = 1 << (shift2 - 1)
    gx = x_int + px + pad
    gy = y_int + py + pad
    r00 = plane[gy, gx].astype(np.int64)
    r01 = plane[gy, gx + 1].astype(np.int64)
    r10 = plane[gy + 1, gx].astype(np.int64)
    r11 = plane[gy + 1, gx + 1].astype(np.int64)
    cx0, cx1 = BL_EIF[xf, 0], BL_EIF[xf, 1]
    cy0, cy1 = BL_EIF[yf, 0], BL_EIF[yf, 1]
    s1 = (cx0 * r00 + cx1 * r01) >> shift1
    s2 = (cx0 * r10 + cx1 * r11) >> shift1
    buf = ((cy0 * s1 + cy1 * s2 + offset2) >> shift2).astype(np.int16)

    # 3-tap horizontal high-pass over columns 1..bw, stored s16 with wrap
    sh2 = max(bd + 5 - 16, 0)
    sh3 = 6 - sh2
    off2 = (1 << (sh2 - 1)) if sh2 > 0 else 0
    off3 = 1 << (sh3 - 1)
    h1 = ((-buf[:, 0:bw].astype(np.int32) + 10 * buf[:, 1:bw + 1]
           - buf[:, 2:bw + 2] + off2) >> sh2).astype(np.int16)
    # vertical pass over the bh middle rows
    res = (-h1[0:bh].astype(np.int32) + 10 * h1[1:bh + 1]
           - h1[2:bh + 2] + off3) >> sh3
    return np.clip(res, 0, (1 << bd) - 1)


def affine_mc_lc(pic, x, y, pic_w, pic_h, cuw, cuh, ac_mv, vertex_num,
                 sub_w, sub_h, mem_band_ok, bd, bd_c, cfi):
    """One-list affine MC, luma + chroma (ref: xevdm_affine_mc_lc).
    Returns (py_, pu_, pv_) int32 blocks (chroma None when cfi == 0)."""
    cw_s = 1 if cfi in (1, 2) else 0
    ch_s = 1 if cfi == 1 else 0
    bit = MAX_CU_LOG2
    mc_prec = 4
    shift = bit - 2
    hor_max = (pic_w + MAX_CU_SIZE - x - cuw) << mc_prec
    ver_max = (pic_h + MAX_CU_SIZE - y - cuh) << mc_prec
    hor_min = (-MAX_CU_SIZE - x) << mc_prec
    ver_min = (-MAX_CU_SIZE - y) << mc_prec
    mv_scale = [ac_mv[0][0] << bit, ac_mv[0][1] << bit]
    d_hor, d_ver = _model_params(ac_mv, cuw, cuh, vertex_num, bit)

    b_eif = sub_w < 8 or sub_h < 8
    if b_eif:
        max_mv, min_mv = _eif_clip_range(x, y, cuw, cuh, d_hor, d_ver,
                                         mv_scale, pic_w, pic_h,
                                         not mem_band_ok)
        clip_l = _can_clip_occur(cuw, cuh, mv_scale, d_hor, d_ver,
                                 max_mv, min_mv)
        py_ = _eif_one(pic.y, pic.pad_l, x, y, cuw, cuh, mv_scale, d_hor,
                       d_ver, max_mv, min_mv, clip_l, bd)
        pu_ = pv_ = None
        if cfi:
            mv0c = [mv_scale[0] >> cw_s, mv_scale[1] >> ch_s]
            maxc = [max_mv[0] >> cw_s, max_mv[1] >> ch_s]
            minc = [min_mv[0] >> cw_s, min_mv[1] >> ch_s]
            bwc, bhc = cuw >> cw_s, cuh >> ch_s
            clip_c = _can_clip_occur(bwc, bhc, mv0c, d_hor, d_ver,
                                     maxc, minc)
            pu_ = _eif_one(pic.u, pic.pad_c, x >> cw_s, y >> ch_s, bwc,
                           bhc, mv0c, d_hor, d_ver, maxc, minc, clip_c,
                           bd_c)
            pv_ = _eif_one(pic.v, pic.pad_c, x >> cw_s, y >> ch_s, bwc,
                           bhc, mv0c, d_hor, d_ver, maxc, minc, clip_c,
                           bd_c)
        return py_, pu_, pv_

    # block path: constant MV at the first sub-block center (ref quirk)
    half_w, half_h = sub_w >> 1, sub_h >> 1
    th = mv_scale[0] + d_hor[0] * half_w + d_ver[0] * half_h
    tv = mv_scale[1] + d_hor[1] * half_w + d_ver[1] * half_h
    th, tv = mv_rounding(th, tv, shift, 0)
    th = max(-(1 << 17), min((1 << 17) - 1, th))
    tv = max(-(1 << 17), min((1 << 17) - 1, tv))
    ori_h, ori_v = th, tv
    th = min(hor_max, max(hor_min, th))
    tv = min(ver_max, max(ver_min, tv))

    py_ = np.zeros((cuh, cuw), dtype=np.int32)
    pu_ = pv_ = None
    if cfi:
        pu_ = np.zeros((cuh >> ch_s, cuw >> cw_s), dtype=np.int32)
        pv_ = np.zeros_like(pu_)
    pad, pad_c = pic.pad_l, pic.pad_c
    for h in range(0, cuh, sub_h):
        for w in range(0, cuw, sub_w):
            gx = ((x + w) << mc_prec) + th
            gy = ((y + h) << mc_prec) + tv
            fy, fx = ori_v & 15, ori_h & 15
            py_[h:h + sub_h, w:w + sub_w] = RN.mc_luma(
                pic.y, gx + (pad << 4), gy + (pad << 4), fx, fy, sub_w,
                sub_h, bd, pad, main_taps=True)
            if cfi:
                fxc, fyc = ori_h & 31, ori_v & 31
                pu_[h >> ch_s:(h + sub_h) >> ch_s,
                    w >> cw_s:(w + sub_w) >> cw_s] = RN.mc_chroma(
                        pic.u, gx + (pad_c << 5), gy + (pad_c << 5),
                        fxc, fyc, sub_w >> cw_s, sub_h >> ch_s, bd_c,
                        main_taps=True)
                pv_[h >> ch_s:(h + sub_h) >> ch_s,
                    w >> cw_s:(w + sub_w) >> cw_s] = RN.mc_chroma(
                        pic.v, gx + (pad_c << 5), gy + (pad_c << 5),
                        fxc, fyc, sub_w >> cw_s, sub_h >> ch_s, bd_c,
                        main_taps=True)
    return py_, pu_, pv_


def affine_mc(x, y, pic_w, pic_h, cuw, cuh, refi, aff_mv, refp,
              vertex_num, bd, bd_c, cfi):
    """Bi-capable affine MC (ref: xevdm_affine_mc).  aff_mv: [2][3][2].
    Returns (py_, pu_, pv_) averaged int32."""
    sub_w, sub_h, mem_band_ok = derive_affine_subblock_size_bi(
        aff_mv, refi, cuw, cuh, vertex_num)
    preds = []
    for lidx in range(2):
        if refi[lidx] < 0:
            continue
        pic = refp[refi[lidx]][lidx].pic
        preds.append(affine_mc_lc(pic, x, y, pic_w, pic_h, cuw, cuh,
                                  aff_mv[lidx], vertex_num, sub_w, sub_h,
                                  mem_band_ok, bd, bd_c, cfi))
    if len(preds) == 2:
        py_ = RN.bi_average(preds[0][0], preds[1][0])
        pu_ = pv_ = None
        if cfi:
            pu_ = RN.bi_average(preds[0][1], preds[1][1])
            pv_ = RN.bi_average(preds[0][2], preds[1][2])
        return py_, pu_, pv_
    return preds[0]
