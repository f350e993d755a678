"""DRA — dynamic range adjustment (Main profile, tool_dra).

Out-of-loop: applied at PULL time to a copy of the output picture (the DPB
keeps the un-mapped pixels for referencing) using 1024-entry inverse LUTs
built from the APS-signalled piecewise-linear scales
(ref: src_main/xevdm_dra.c:40-267 LUT construction, :270-355 application,
src_main/xevdm.c:3351-3386 pull-time invocation).

The LUT build runs per pull on the host (tiny); the per-pixel application
is pure gathers — numpy here, and trivially deviceable if it ever shows up
in a profile (it is a single gather per plane).
"""
from __future__ import annotations

import numpy as np

from .. import tables as T

SCALE_NUMFBITS = 9
INVSCALE_NUMFBITS = 9
DRA_LUT_MAXSIZE = 1024
NUM_CHROMA_QP_SCALE_EXP = 25


def _range_idx(sample, ranges, num_ranges):
    """(ref: src_main/xevdm_dra.c:103-117)"""
    for i in range(num_ranges):
        if sample < ranges[i + 1]:
            return min(i, num_ranges - 1)
    return num_ranges - 1


def _scaled_chroma_qp(chroma_qp_tbl, comp, qp, bd):
    """(ref: src_main/xevdm_dra.c:96-102)"""
    off = 6 * (bd - 8)
    v = min(max(qp, -off), 57)
    return int(chroma_qp_tbl[comp - 1][v + off])


def _correct_local_chroma_scale(p, scale_luma, ch, bd, chroma_qp_tbl):
    """(ref: src_main/xevdm_dra.c:118-196)"""
    tbl = T.DRA_CHROMA_QP_OFFSET
    SCALE_OFFSET = 1 << SCALE_NUMFBITS
    T0S = NUM_CHROMA_QP_SCALE_EXP >> 1
    cbcr = p.dra_cb_scale_value if ch == 1 else p.dra_cr_scale_value
    if p.dra_table_idx == 58:
        return cbcr
    scale_int = cbcr * scale_luma
    shift1 = p.dra_table_idx - _scaled_chroma_qp(
        chroma_qp_tbl, ch, p.dra_table_idx, bd)
    s9 = (scale_int + (1 << 8)) >> 9
    idx = _range_idx(s9, tbl, len(tbl) - 1)
    num = s9 - int(tbl[idx])
    den = int(tbl[idx + 1]) - int(tbl[idx])
    qp_int = 2 * idx - 60
    if num == 0:
        qp_int -= 1
        qp_frac = 0
    else:
        qp_frac = SCALE_OFFSET * (num << 1) // den
        qp_int += qp_frac // SCALE_OFFSET
        qp_frac = SCALE_OFFSET - (qp_frac % SCALE_OFFSET)
    local_qp = p.dra_table_idx - qp_int
    off = 6 * (bd - 8)
    qp0 = _scaled_chroma_qp(chroma_qp_tbl, ch,
                            min(max(local_qp, -off), 57), bd)
    qp1 = _scaled_chroma_qp(chroma_qp_tbl, ch,
                            min(max(local_qp + 1, -off), 57), bd)
    qp_dec = (qp1 - qp0) * qp_frac
    frac_adj = qp_dec % (1 << 9)
    int_adj = qp_dec >> 9
    frac_adj = qp_frac - frac_adj
    shift2 = local_qp - qp0 - int_adj
    qp_shift = shift2 - shift1
    if frac_adj < 0:
        qp_shift -= 1
        frac_adj = (1 << 9) + frac_adj
    cl = min(max(qp_shift, -12), 12)
    sshift = int(T.DRA_EXP_NOM[cl + T0S])
    if qp_shift >= 0:
        sfrac = int(T.DRA_EXP_NOM[min(max(qp_shift + 1, -12), 12) + T0S]) \
            - sshift
    else:
        sfrac = sshift - int(
            T.DRA_EXP_NOM[min(max(qp_shift - 1, -12), 12) + T0S])
    out = sshift + ((sfrac * frac_adj + (1 << (SCALE_NUMFBITS - 1)))
                    >> SCALE_NUMFBITS)
    return (scale_int * out + (1 << 17)) >> 18


def build_dra_luts(p, bd, chroma_qp_tbl):
    """Build (luma_inv_lut [1024], chroma_inv_lut [2][1024]) from a
    SigParamDra (ref: src_main/xevdm_dra.c:61-267)."""
    nr = p.num_ranges
    nmb = SCALE_NUMFBITS + INVSCALE_NUMFBITS
    in_ranges = [int(v) for v in p.in_ranges[:nr + 1]]
    scales = [int(v) for v in p.dra_scale_value[:nr]]

    out_ranges = [0] * (nr + 1)
    for i in range(1, nr + 1):
        out_ranges[i] = out_ranges[i - 1] + \
            (in_ranges[i] - in_ranges[i - 1]) * scales[i - 1]
    inv_scales = [0] * nr
    inv_offsets = [0] * nr
    for i in range(nr):
        inv2 = ((1 << nmb) + (scales[i] >> 1)) // scales[i]
        diff2 = out_ranges[i + 1] * inv2
        inv_offsets[i] = ((in_ranges[i + 1] << nmb) - diff2
                          + (1 << (p.dra_descriptor2 - 1))) \
            >> p.dra_descriptor2
        inv_scales[i] = inv2
    for i in range(nr + 1):
        out_ranges[i] = (out_ranges[i]
                         + (1 << (p.dra_descriptor2 - 1))) >> p.dra_descriptor2

    # chroma per-range scales (ref :197-204)
    ch_scales = [[0] * nr, [0] * nr]
    ch_inv = [[0] * nr, [0] * nr]
    for ch in (1, 2):
        for i in range(nr):
            s = _correct_local_chroma_scale(p, scales[i], ch, bd,
                                            chroma_qp_tbl)
            ch_scales[ch - 1][i] = s
            ch_inv[ch - 1][i] = ((1 << 18) + (s >> 1)) // s

    # luma inverse LUT (ref :205-217)
    luma_lut = np.zeros(DRA_LUT_MAXSIZE, np.int32)
    for i in range(DRA_LUT_MAXSIZE):
        ri = _range_idx(i, out_ranges, nr)
        v = i * inv_scales[ri]
        v = (inv_offsets[ri] + v + (1 << 8)) >> 9
        luma_lut[i] = min(max(v, 0), DRA_LUT_MAXSIZE - 1)

    # chroma inverse LUT (ref :219-267)
    chroma_lut = np.ones((2, DRA_LUT_MAXSIZE), np.int32)
    for ch in range(2):
        mr = [0] * (nr + 2)
        msc = [0] * (nr + 1)
        moff = [0] * (nr + 1)
        mr[0] = out_ranges[0]
        msc[0] = 0
        moff[0] = ch_inv[ch][0]
        for i in range(1, nr + 1):
            mr[i] = (out_ranges[i - 1] + out_ranges[i]) // 2
        for i in range(1, nr):
            dr = mr[i + 1] - mr[i]
            moff[i] = ch_inv[ch][i - 1]
            dsc = ch_inv[ch][i] - moff[i]
            # C truncating division (dsc may be negative)
            num = (dsc << bd) + (dr >> 1)
            msc[i] = -((-num) // dr) if num < 0 else num // dr
        msc[nr] = 0
        moff[nr] = ch_inv[ch][nr - 1]
        for i in range(DRA_LUT_MAXSIZE):
            ri = _range_idx(i, mr, nr + 1)
            run_i = i - mr[ri]
            run_s = (msc[ri] * run_i + (1 << (bd - 1))) >> bd
            chroma_lut[ch][i] = moff[ri] + run_s
    return luma_lut, chroma_lut


def apply_dra_inverse(y, u, v, luma_lut, chroma_lut):
    """Inverse-map (y, u, v) planes in place; chroma first (it reads the
    un-mapped luma as its range reference), then luma
    (ref: src_main/xevdm_dra.c:270-355, order xevdm.c:3342-3344)."""
    rnd = 1 << (INVSCALE_NUMFBITS - 1)
    ref = np.maximum(np.asarray(y)[::2, ::2].astype(np.int32), 0)
    for ch, plane in ((0, u), (1, v)):
        if plane is None:
            continue
        s = plane.astype(np.int32) - 512
        scale = chroma_lut[ch][np.clip(ref[:s.shape[0], :s.shape[1]],
                                       0, DRA_LUT_MAXSIZE - 1)]
        mag = (np.abs(s) * scale + rnd) >> INVSCALE_NUMFBITS
        plane[:] = (512 + np.where(s < 0, -mag, mag)).astype(plane.dtype)
    yv = np.clip(np.asarray(y).astype(np.int32), 0, DRA_LUT_MAXSIZE - 1)
    y[:] = luma_lut[yv].astype(y.dtype)
