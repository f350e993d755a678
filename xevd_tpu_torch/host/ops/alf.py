"""ALF — adaptive loop filter (Main profile, tool_alf), host oracle.

Mirrors the reference behavior (ref: src_main/xevdm_alf.c): per-CTU local
buffers with 3-px margins taken from the PRE-ALF picture (so CTUs are
mutually independent — ALF is a pure function of the post-deblock frame),
4x4-block gradient classification into 25 classes x 4 transposes, 7x7
luma / 5x5 chroma diamond filters, coefficient reconstruction with
fixed-filter prediction.

Margin semantics (faithful to the per-CTU buffer construction,
ref :806-1055): the picture is first edge-REPLICATED (tile extend); then a
CTU's left margin is MIRRORED when the CTU sits at the picture's left
edge, top margin rows are mirrored at the picture's top (copied as full
rows after the side margins), and with pps.loop_filter_across_tiles
disabled the right/bottom picture edges mirror as well.  Interior CTU
margins read the real (pre-ALF) neighbor pixels.
"""
from __future__ import annotations

import numpy as np

from .. import tables as T
from ..tables_alf import (ALF_CLASS_TO_FILTER_MAPPING, ALF_FIXED_FILTER_COEF,
                          PATTERN_TO_LARGE_FILTER_5,
                          PATTERN_TO_LARGE_FILTER_7)

_ACT_TH = np.array([0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4],
                   np.int32)
_TRANS_TBL = np.array([0, 1, 0, 2, 2, 3, 1, 3], np.int32)
# coefficient transpose mappings (ref :267-273)
_L_TBL = np.array([
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12],
    [9, 4, 10, 8, 1, 5, 11, 7, 3, 0, 2, 6, 12],
    [0, 3, 2, 1, 8, 7, 6, 5, 4, 9, 10, 11, 12],
    [9, 8, 10, 4, 3, 7, 11, 5, 1, 0, 2, 6, 12]], np.int32)

# 7x7 diamond tap offsets per coefficient (pairs), (dy, dx)
_TAPS7 = [
    [(3, 0), (-3, 0)],
    [(2, 1), (-2, -1)], [(2, 0), (-2, 0)], [(2, -1), (-2, 1)],
    [(1, 2), (-1, -2)], [(1, 1), (-1, -1)], [(1, 0), (-1, 0)],
    [(1, -1), (-1, 1)], [(1, -2), (-1, 2)],
    [(0, 3), (0, -3)], [(0, 2), (0, -2)], [(0, 1), (0, -1)], [(0, 0)]]
_TAPS5 = [
    [(2, 0), (-2, 0)],
    [(1, 1), (-1, -1)], [(1, 0), (-1, 0)], [(1, -1), (-1, 1)],
    [(0, 2), (0, -2)], [(0, 1), (0, -1)], [(0, 0)]]

NUM_BITS = 10


def recon_coef_luma(p) -> np.ndarray:
    """Reconstruct the 25x13 final luma coefficients from an AlfSliceParam
    (ref: src_main/xevdm_alf.c:700-777)."""
    ncoef = 13 if p.luma_filter_type else 7
    coeff = np.array(p.luma_coeff, np.int64).reshape(25, 13).copy()
    if p.coeff_delta_pred_mode_flag:
        for i in range(1, p.num_luma_filters):
            coeff[i, :ncoef - 1] += coeff[i - 1, :ncoef - 1]
    p2l = (PATTERN_TO_LARGE_FILTER_7 if p.luma_filter_type
           else PATTERN_TO_LARGE_FILTER_5)
    out = np.zeros((25, 13), np.int64)
    for cls in range(25):
        fidx = p.filter_coeff_delta_idx[cls]
        usage = p.fixed_filter_usage_flag[cls]
        ffidx = p.fixed_filter_idx[cls]
        if usage:
            ffidx = ALF_CLASS_TO_FILTER_MAPPING[cls][ffidx]
        for i in range(12):
            cur = int(ALF_FIXED_FILTER_COEF[ffidx][i]) if usage else 0
            if p2l[i] > 0:
                cur += coeff[fidx, p2l[i] - 1]
            out[cls, i] = cur
        out[cls, 12] = (1 << (NUM_BITS - 1)) - 2 * out[cls, :12].sum()
    return out.astype(np.int32)


def recon_coef_chroma(p) -> np.ndarray:
    """(ref: src_main/xevdm_alf.c:779-795, chroma branch)"""
    c = np.array(p.chroma_coeff[:7], np.int64)
    c[6] = (1 << (NUM_BITS - 1)) - 2 * c[:6].sum()
    return c.astype(np.int32)


def _extend(plane, m=3):
    """Tile-extend (edge replicate) the whole picture with m margins."""
    return np.pad(plane, m, mode="edge").astype(np.int32)


def _ctu_buffer(ext, x, y, w_b, h_b, avail_l, avail_r, avail_t, avail_b,
                m=3):
    """Local (h_b+2m, w_b+2m) buffer for the CTU at (x, y)
    (ref: src_main/xevdm_alf.c:1000-1052): interior + side margins from the
    extended picture; unavailable sides mirror; top/bottom margin rows are
    full-row copies done after the side margins."""
    e = ext[y:y + h_b + 2 * m, x:x + w_b + 2 * m].copy()
    # e local coords: row/col m..m+h_b-1 is the CTU interior
    if not avail_l:
        for j in range(m):
            e[m:m + h_b, j] = e[m:m + h_b, 2 * m - j]
    if not avail_r:
        for j in range(m):
            e[m:m + h_b, m + w_b + j] = e[m:m + h_b, m + w_b - j - 2]
    if not avail_t:
        for i in range(m):
            e[i] = e[2 * m - i]
    if not avail_b:
        for k in range(m):
            e[m + h_b + k] = e[m + h_b - k - 2]
    return e


def classify_block(buf, w_b, h_b, bd, m=3):
    """Per-4x4 (class_idx, trans_idx) for a CTU local buffer
    (ref: src_main/xevdm_alf.c:38-209).  Returns int32 [h_b//4, w_b//4]
    packed as (class << 2) | trans."""
    # laplacian pair-sums at even offsets (P, Q), P in -2..h_b+1
    # (buffer row m+P); need pixel rows P-1..P+2 -> buffer m-3..m+h_b+3
    pix = buf.astype(np.int32)

    def at(dy, dx):
        # pixel value at (P+dy, Q+dx) for all even grid points
        return pix[m - 2 + dy:m + h_b + 2 + dy:2,
                   m - 2 + dx:m + w_b + 2 + dx:2]

    def at1(dy, dx):
        # same but for the odd row partner (P+1+dy)
        return pix[m - 1 + dy:m + h_b + 3 + dy:2,
                   m - 2 + dx:m + w_b + 2 + dx:2]

    a = np.abs
    v0 = a(2 * at(0, 0) - at(-1, 0) - at(1, 0)) \
        + a(2 * at(0, 1) - at(-1, 1) - at(1, 1))
    v1 = a(2 * at1(0, 0) - at1(-1, 0) - at1(1, 0)) \
        + a(2 * at1(0, 1) - at1(-1, 1) - at1(1, 1))
    Lv = v0 + v1
    h0 = a(2 * at(0, 0) - at(0, 1) - at(0, -1)) \
        + a(2 * at(0, 1) - at(0, 2) - at(0, 0))
    h1 = a(2 * at1(0, 0) - at1(0, 1) - at1(0, -1)) \
        + a(2 * at1(0, 1) - at1(0, 2) - at1(0, 0))
    Lh = h0 + h1
    d00 = a(2 * at(0, 0) - at(-1, -1) - at(1, 1)) \
        + a(2 * at(0, 1) - at(-1, 0) - at(1, 2))
    d01 = a(2 * at1(0, 0) - at1(-1, -1) - at1(1, 1)) \
        + a(2 * at1(0, 1) - at1(-1, 0) - at1(1, 2))
    Ld0 = d00 + d01
    d10 = a(2 * at(0, 0) - at(1, -1) - at(-1, 1)) \
        + a(2 * at(0, 1) - at(1, 0) - at(-1, 2))
    d11 = a(2 * at1(0, 0) - at1(1, -1) - at1(-1, 1)) \
        + a(2 * at1(0, 1) - at1(1, 0) - at1(-1, 2))
    Ld1 = d10 + d11

    # 4x4-block sums: each block sums a 4x4 group of grid samples
    nby, nbx = h_b // 4, w_b // 4

    def bsum(L):
        # block (bi, bj) sums grid rows 2bi..2bi+3 x cols 2bj..2bj+3
        c = np.cumsum(np.vstack([np.zeros((1, L.shape[1]), L.dtype), L]), 0)
        rows = c[4::2][:nby] - c[0::2][:nby]           # sum of 4 grid rows
        c2 = np.cumsum(np.hstack([np.zeros((rows.shape[0], 1), L.dtype),
                                  rows]), 1)
        return c2[:, 4::2][:, :nbx] - c2[:, 0::2][:, :nbx]

    sv = bsum(Lv)
    sh_ = bsum(Lh)
    sd0 = bsum(Ld0)
    sd1 = bsum(Ld1)

    act = np.clip((sv + sh_) >> (bd - 2), 0, 15)
    cls = _ACT_TH[act]
    hv1 = np.maximum(sv, sh_)
    hv0 = np.minimum(sv, sh_)
    dir_hv = np.where(sv > sh_, 1, 3)
    d1 = np.maximum(sd0, sd1)
    d0 = np.minimum(sd0, sd1)
    dir_d = np.where(sd0 > sd1, 0, 2)
    # NB: the reference computes these products in (wrapping) 32-bit int —
    # they genuinely overflow at 10-bit — so bit-exactness requires the
    # same wrap-around semantics, not exact wide math
    with np.errstate(over="ignore"):
        use_d = (d1.astype(np.int32) * hv0.astype(np.int32)
                 > hv1.astype(np.int32) * d0.astype(np.int32))
    hvd1 = np.where(use_d, d1, hv1)
    hvd0 = np.where(use_d, d0, hv0)
    main_dir = np.where(use_d, dir_d, dir_hv)
    sec_dir = np.where(use_d, dir_hv, dir_d)
    ds = np.zeros_like(cls)
    ds = np.where(hvd1 > 2 * hvd0, 1, ds)
    ds = np.where(hvd1 * 2 > 9 * hvd0, 2, ds)
    cls = np.where(ds > 0, cls + (((main_dir & 1) << 1) + ds) * 5, cls)
    trans = _TRANS_TBL[main_dir * 2 + (sec_dir >> 1)]
    return (cls << 2) | trans


def filter_luma_block(buf, cl, coef_final, w_b, h_b, bd, m=3):
    """7x7 diamond filter on a CTU buffer; cl [h_b//4, w_b//4] packed
    class/trans (ref: src_main/xevdm_alf.c:210-338).  Returns [h_b, w_b]."""
    trans = cl & 3
    cls = (cl >> 2) & 0x1F
    # per-4x4-block 13 effective coefficients
    co = coef_final[cls[..., None], _L_TBL[trans]]     # [nby, nbx, 13]
    co_px = np.repeat(np.repeat(co, 4, 0), 4, 1)       # [h_b, w_b, 13]
    acc = np.zeros((h_b, w_b), np.int64)
    c0 = buf[m:m + h_b, m:m + w_b]
    for i, taps in enumerate(_TAPS7):
        s = np.zeros_like(c0)
        for dy, dx in taps:
            s = s + buf[m + dy:m + dy + h_b, m + dx:m + dx + w_b]
        acc += co_px[..., i].astype(np.int64) * s
    out = (acc + 256) >> 9
    return np.clip(out, 0, (1 << bd) - 1)


def filter_chroma_block(buf, coef, w_b, h_b, bd, m=3):
    """5x5 diamond with a single 7-coef filter (ref :339-430)."""
    acc = np.zeros((h_b, w_b), np.int64)
    for i, taps in enumerate(_TAPS5):
        s = np.zeros((h_b, w_b), np.int64)
        for dy, dx in taps:
            s = s + buf[m + dy:m + dy + h_b, m + dx:m + dx + w_b]
        acc += int(coef[i]) * s
    out = (acc + 256) >> 9
    return np.clip(out, 0, (1 << bd) - 1)


def alf_frame(planes, w, h, param, alf_ctu_on, enable, log2_ctu, bd,
              across_tiles=True):
    """Apply ALF in place to (y, u, v) frame planes (pre-pad, [h_pad, w_pad]
    arrays; only the [h, w] area is read/written).

    param: aps.AlfSliceParam with luma (+chroma) coefficients;
    alf_ctu_on: per-CTU luma enable (raster);
    enable: (luma_on, u_on, v_on) from SH."""
    y_plane, u_plane, v_plane = planes
    ctu = 1 << log2_ctu
    n_w = (w + ctu - 1) >> log2_ctu
    coef_luma = recon_coef_luma(param)
    coef_chroma = (recon_coef_chroma(param)
                   if (enable[1] or enable[2]) else None)
    ext_y = _extend(y_plane[:h, :w])
    if enable[1] or enable[2]:
        ext_u = _extend(u_plane[:h >> 1, :w >> 1])
        ext_v = _extend(v_plane[:h >> 1, :w >> 1])

    for yp in range(0, h, ctu):
        for xp in range(0, w, ctu):
            w_b = min(ctu, w - xp)
            h_b = min(ctu, h - yp)
            ctu_idx = (yp >> log2_ctu) * n_w + (xp >> log2_ctu)
            if across_tiles:
                av_l, av_t = xp != 0, yp != 0
                av_r = av_b = True
            else:
                av_l, av_t = xp != 0, yp != 0
                av_r = xp + w_b != w
                av_b = yp + h_b != h
            if enable[0] and alf_ctu_on[ctu_idx]:
                buf = _ctu_buffer(ext_y, xp, yp, w_b, h_b, av_l, av_r,
                                  av_t, av_b)
                cl = classify_block(buf, w_b, h_b, bd)
                y_plane[yp:yp + h_b, xp:xp + w_b] = filter_luma_block(
                    buf, cl, coef_luma, w_b, h_b, bd).astype(y_plane.dtype)
            for en, ext_c, plane in ((enable[1], "u", u_plane),
                                     (enable[2], "v", v_plane)):
                if not en:
                    continue
                e = ext_u if ext_c == "u" else ext_v
                bufc = _ctu_buffer(e, xp >> 1, yp >> 1, w_b >> 1, h_b >> 1,
                                   av_l, av_r, av_t, av_b)
                plane[yp >> 1:(yp + h_b) >> 1, xp >> 1:(xp + w_b) >> 1] = \
                    filter_chroma_block(bufc, coef_chroma, w_b >> 1,
                                        h_b >> 1, bd).astype(plane.dtype)
