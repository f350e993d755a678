"""Main-profile (EIPD) intra reconstruction over a wavefront level schedule,
with HTDF (the port of K6 `intra_scan_wave`,
xevd_tpu/ops/jax_intra_main.py:572, with K7 `_htdf_tile`, :447).

`intra_scan_wave` updates the bordered picture planes in place: the CUDA
kernels (csrc/intra_main.cu, a level loop in the C entry point) for CUDA
planes, `intra_scan_wave_ref` for CPU planes.  The plain versions below are
written from the JAX functions of the same names; they compute a CU's own
width and height and its one mode, where the JAX version evaluates every
mode on a fixed S x S tile and selects.

Per level, as in the JAX scan step: every CU of the level predicts from the
planes as the previous levels left them (its up, left and right neighbour
arrays with last-available fill, `fill_dir_ref` / `nbr_main_ref`), adds its
residual (int16 wrap, clip) and writes luma where its tree is not TREE_C
and chroma where it is not TREE_L; then HTDF filters the level's HTDF CUs
(luma only) from the planes after those writes."""
from __future__ import annotations

import torch

from ..host import tables as T

from ..kernels import build as K
from .pack import (ICM_CORNER, ICM_DO_INTRA, ICM_HTDF_AVAIL, ICM_HTDF_IDX,
                   ICM_IPM, ICM_IPM_C, ICM_LEFT, ICM_LOG2H, ICM_LOG2W,
                   ICM_LR, ICM_RIGHT, ICM_TREE, ICM_UP, ICM_VALID, ICM_X,
                   ICM_Y)
from .tables import (BORDER, EIPD_IBM, EIPD_IBS, EIPD_LUTP1, EIPD_WC)

LR_01, LR_11 = 2, 3      # left/right availability: right only, both
_I32 = torch.int32


def _clip(v, maxv):
    return v.clamp(0, maxv)


def fill_dir_ref(raw: torch.Tensor, mask: int, lg_unit: int,
                 seed) -> torch.Tensor:
    """Forward per-unit availability fill (jax_intra_main.py:127): raw
    int32 [n]; unit i covers raw[i << lg_unit:(i + 1) << lg_unit] and is
    available where bit i of the uint32 `mask` is set.  An unavailable
    sample takes the last sample of the nearest available unit to its
    left, or `seed` if there is none."""
    n = raw.shape[0]
    dev = raw.device
    iu = torch.arange(n >> lg_unit, device=dev)
    avail = (torch.tensor(int(mask) & 0xFFFFFFFF, device=dev) >> iu) & 1
    lastu = torch.cummax(torch.where(avail == 1, iu, -1), 0).values
    unit = torch.arange(n, device=dev) >> lg_unit
    li = lastu[unit]
    rep = raw[((li << lg_unit) + (1 << lg_unit) - 1).clamp(0, n - 1)]
    seed = torch.as_tensor(seed, dtype=raw.dtype, device=dev)
    return torch.where(li < 0, seed, torch.where(avail[unit] == 1, raw, rep))


def nbr_main_ref(rec, x, y, lw, lh, up_mask, left_mask, right_mask, corner,
                 lg_unit, bd):
    """(upg, leg, rig): int32 [w + h + 1] neighbour arrays of one CU on one
    bordered plane, [0] the position -1 (jax_intra_main.py:328): the up row
    from the corner-or-mid seed; up[-1] the corner sample where the corner
    is available, else the filled up[0], which also seeds the left column;
    the right column seeded with up[w]."""
    w, h = 1 << lw, 1 << lh
    n = w + h
    by, bx = BORDER + y, BORDER + x
    mid = 1 << (bd - 1)
    row = rec[by - 1, bx - 1:bx + n].to(_I32)     # corner, then up row
    corner_px = row[0]
    seed_up = corner_px if corner == 1 else mid
    up = fill_dir_ref(row[1:], up_mask, lg_unit, seed_up)
    up_m1 = corner_px if corner == 1 else up[0]
    le = fill_dir_ref(rec[by:by + n, bx - 1].to(_I32), left_mask, lg_unit,
                      up_m1)
    ri_m1 = up[w]
    ri = fill_dir_ref(rec[by:by + n, bx + w].to(_I32), right_mask, lg_unit,
                      ri_m1)

    def ext(first, arr):
        return torch.cat([torch.as_tensor(first, dtype=_I32,
                                          device=arr.device).reshape(1), arr])
    return ext(up_m1, up), ext(up_m1, le), ext(ri_m1, ri)


def _get_dc(numer, lw, lh):
    """(ref: src_base/xevd_ipred.c:124-144)"""
    return (numer * int(EIPD_LUTP1[abs(lw - lh)])) >> (min(lw, lh) + 12)


def _angular(upg, leg, rig, ipm, lw, lh, lr, ii, jj, maxv):
    """Angular modes (jax_intra_main.py:256-317): per sample a reference
    side (0 up, 1 left, 2 right), position and 1/32 offset, then the 4-tap
    ADI filter."""
    w, h = 1 << lw, 1 << lh
    right_av = (lr & 2) != 0
    m0, m1 = (int(v) for v in T.IPRED_DXDY[min(max(ipm, 0), 32)])

    def grp(m, d):
        prod = d * m
        d_out = prod >> 10
        return d_out, (prod >> 5) - (d_out << 5)

    ii, jj = ii.expand(h, w), jj.expand(h, w)
    one = torch.ones_like(ii)
    if ipm < T.IPD_VER:
        tdx1, offa1 = grp(m0, jj + 1)
        tdy1, offb1 = grp(m1, w - ii)
        cond = (ii >= w - tdx1) & right_av
        refpos = torch.where(cond, 2 * one, 0 * one)
        pos = torch.where(cond, jj - tdy1, ii + tdx1)
        off = torch.where(cond, offb1, offa1)
    elif ipm > T.IPD_HOR:
        if right_av:
            tdyr, offr = grp(m1, w - ii)
            tdxr, offr2 = grp(m0, w - ii)
            cond = jj < tdyr
            refpos = torch.where(cond, 0 * one, 2 * one)
            pos = torch.where(cond, ii + tdxr, jj - tdyr)
            off = torch.where(cond, offr2, offr)
        else:
            tdyl, off = grp(m1, ii + 1)
            refpos, pos = one, jj + tdyl
    else:
        tdy3, offa3 = grp(m1, ii + 1)
        cond = jj < tdy3
        tdx3, offb3 = grp(m0, jj + 1)
        tdy3b, offc3 = grp(m1, w - ii)
        is01 = lr == LR_01
        refpos = torch.where(cond, 0 * one, (2 if is01 else 1) * one)
        pos = torch.where(cond, ii - tdx3, jj + tdy3b if is01 else jj - tdy3)
        off = torch.where(cond, offb3, offc3 if is01 else offa3)
    dxy = -1 if (ipm < T.IPD_VER or ipm > T.IPD_HOR) else 1
    asc = torch.where(refpos == 2, -dxy, dxy) < 0
    k0 = torch.where(asc, pos - 1, pos + 1)
    k2 = torch.where(asc, pos + 1, pos - 1)
    k3 = torch.where(asc, pos + 2, pos - 2)
    n1 = w + h + 1
    flat = torch.cat([upg, leg, rig])

    def gat(k):
        return flat[(refpos * n1 + k.clamp(-1, w + h - 1) + 1).long()]

    filt = torch.as_tensor(T.IPRED_ADI, dtype=_I32, device=upg.device)[
        off.clamp(0, 31).long()]                           # [h, w, 4]
    acc = (gat(k0) * filt[..., 0] + gat(pos) * filt[..., 1]
           + gat(k2) * filt[..., 2] + gat(k3) * filt[..., 3])
    return _clip((acc + 64) >> 7, maxv)


def predict_main_ref(upg, leg, rig, ipm, lw, lh, lr, bd) -> torch.Tensor:
    """EIPD prediction int32 [h, w] of one CU in mode `ipm` from its
    neighbour arrays (`nbr_main_ref`), with the CU's left/right
    availability `lr` (jax_intra_main.py:157; ref:
    src_main/xevdm_ipred.c:153-229, src_base/xevd_ipred.c:163-585)."""
    w, h = 1 << lw, 1 << lh
    maxv = (1 << bd) - 1
    dev = upg.device
    ii = torch.arange(w, dtype=_I32, device=dev)[None, :]    # column
    jj = torch.arange(h, dtype=_I32, device=dev)[:, None]    # row
    up0, le0, ri0 = upg[1:], leg[1:], rig[1:]
    right_av = (lr & 2) != 0
    lutp1 = int(EIPD_LUTP1[lw])
    if ipm == T.IPD_VER:
        return up0[:w][None, :].expand(h, w).clone()
    if ipm == T.IPD_HOR:
        vle, vri = le0[:h, None], ri0[:h, None]
        if lr == LR_11:
            return ((vle * (w - ii) + vri * (ii + 1) + (w >> 1))
                    * lutp1) >> 12
        return (vri if lr == LR_01 else vle).expand(h, w).clone()
    if ipm == T.IPD_DC:
        s_le, s_ri = int(le0[:h].sum()), int(ri0[:h].sum())
        s_up = int(up0[:w].sum())
        if lr == LR_11:
            dc = _get_dc(s_le + s_ri + s_up + ((w + h + h) >> 1), lw, lh + 1)
        elif lr == LR_01:
            dc = _get_dc(s_ri + s_up + ((w + h) >> 1), lw, lh)
        else:
            dc = _get_dc(s_le + s_up + ((w + h) >> 1), lw, lh)
        return torch.full((h, w), dc, dtype=_I32, device=dev)
    if ipm == T.IPD_PLN:
        w2, h2 = w >> 1, h >> 1
        kw = torch.arange(1, w2 + 1, device=dev)
        kh = torch.arange(1, h2 + 1, device=dev)
        if right_av:
            coef_h = int((kw * (upg[1 + w2 - kw] - upg[1 + w2 + kw])).sum())
            coef_v = int((kh * (rig[h2 + kh] - rig[h2 - kh])).sum())
            a = int(ri0[h - 1] + up0[0]) << 4
        else:
            coef_h = int((kw * (upg[w2 + kw] - upg[w2 - kw])).sum())
            coef_v = int((kh * (leg[h2 + kh] - leg[h2 - kh])).sum())
            a = int(le0[h - 1] + up0[w - 1]) << 4
        def scaled(coef, lg):
            i = max(lg - 2, 0)
            sh = int(EIPD_IBS[i])
            return ((coef << 5) * int(EIPD_IBM[i]) + (1 << (sh - 1))) >> sh
        b, c = scaled(coef_h, lw), scaled(coef_v, lh)
        temp0 = a - (h2 - 1) * c - (w2 - 1) * b + 16
        steps = (w - 1 - ii) if right_av else ii
        return _clip((temp0 + jj * c + steps * b) >> 5, maxv)
    if ipm == T.IPD_BI:
        up_i = up0[:w][None, :]
        if lr == LR_11:
            def dst(rows):
                return ((le0[rows][:, None] * (w - ii)
                         + ri0[rows][:, None] * (ii + 1) + (w >> 1))
                        * lutp1) >> 12
            dst_tmp = dst(jj[:, 0])
            last = dst(torch.tensor([h - 1], device=dev))
            tmp = (up_i * (h - 1 - jj) + last * (jj + 1) + (h >> 1)) >> lh
            return (dst_tmp + tmp + 1) >> 1
        is01 = lr == LR_01
        aa = int(upg[0]) if is01 else int(up0[w])
        bb = int(ri0[h]) if is01 else int(le0[h])
        ish = min(lw, lh)
        if lw == lh:
            cc = (aa + bb + 1) >> 1
        else:
            cc = ((((aa << lw) + (bb << lh)) * int(EIPD_WC[abs(lw - lh)])
                   + (1 << (ish + 9))) >> (ish + 10))
        wt = (cc << 1) - aa - bb
        ref_up = (up_i << lh) + (jj + 1) * (bb - up_i)
        side = (ri0 if is01 else le0)[:h, None]
        kpx = (w - ii) if is01 else (ii + 1)
        px = (side << lw) + kpx * (aa - side)
        wx = ((w - 1 - ii) if is01 else ii) * jj * wt
        return _clip(((px << lh) + (ref_up << lw) + wx + (1 << (lw + lh)))
                     >> (lw + lh + 1), maxv)
    return _angular(upg, leg, rig, ipm, lw, lh, lr, ii, jj, maxv)


def chroma_ipm_eff(ipm: int, ipm_c: int) -> int:
    """The luma-numbered mode a chroma CU predicts with
    (jax_intra_main.py:538; ref: src_main/xevdm_ipred.c:267-305): DM maps
    VER/HOR/DC/BI to the chroma mode of the same name, else takes the luma
    mode; the named chroma modes map back to their luma numbers."""
    dm = {T.IPD_VER: T.IPD_VER_C, T.IPD_HOR: T.IPD_HOR_C,
          T.IPD_DC: T.IPD_DC_C, T.IPD_BI: T.IPD_BI_C}
    if ipm_c == T.IPD_DM_C and ipm in dm:
        ipm_c = dm[ipm]
    return {T.IPD_DM_C: ipm, T.IPD_BI_C: T.IPD_BI, T.IPD_DC_C: T.IPD_DC,
            T.IPD_HOR_C: T.IPD_HOR}.get(ipm_c, T.IPD_VER)


def pred_tile_ref(rec, resid, x, y, lw, lh, ipm, um, lm, rm, co, lr, lg_unit,
                  bd) -> torch.Tensor:
    """The reconstructed int32 [h, w] CU (jax_intra_main.py:556): the EIPD
    prediction plus the residual, wrapped through int16, clipped."""
    upg, leg, rig = nbr_main_ref(rec, x, y, lw, lh, um, lm, rm, co, lg_unit,
                                 bd)
    pred = predict_main_ref(upg, leg, rig, ipm, lw, lh, lr, bd)
    by, bx = BORDER + y, BORDER + x
    r = resid[by:by + (1 << lh), bx:bx + (1 << lw)].to(_I32)
    return _clip((pred + r).to(torch.int16).to(_I32), (1 << bd) - 1)


def _htdf_read_table(z, tbl_row, thr, shift, rnd):
    """(jax_intra_main.py:44; ref: src_main/xevdm_recon.c:173-187)"""
    v = z.abs()
    w0 = torch.where(v < thr, tbl_row[(((v + rnd) & thr) >> shift).long()], v)
    return torch.where(z < 0, -w0, w0)


def htdf_tile_ref(rec, x, y, lw, lh, avail, tbl_idx, bd) -> torch.Tensor:
    """The HTDF-filtered int32 [h, w] luma CU (jax_intra_main.py:447; ref:
    src_main/xevdm_recon.c:196-385): a 1-px ring from the plane where the
    availability bits (1 left, 2 right, 4 up, 8/16 up-left/right, 32/64
    low-left/right) allow, else the CU's edge replicated, the bottom row
    always replicated; 2x2 Hadamard windows, table shrink of the three AC
    terms, inverse, and the four overlapping windows summed."""
    w, h = 1 << lw, 1 << lh
    by, bx = BORDER + y - 1, BORDER + x - 1
    e = rec[by:by + h + 2, bx:bx + w + 2].to(_I32)
    dev = e.device
    rr = torch.arange(h + 2, device=dev).clamp(max=h)
    rr[0] = 0 if avail & 4 else 1
    cc = torch.arange(w + 2, device=dev).clamp(max=w)
    cc[0] = 0 if avail & 1 else 1
    cc[w + 1] = w + 1 if avail & 2 else w
    val = e[rr[:, None], cc[None, :]]
    val[0, 0] = e[0, 0] if avail & 8 else e[1, 1]
    val[0, w + 1] = e[0, w + 1] if avail & 16 else e[1, w]
    val[h + 1, 0] = e[h + 1, 0] if avail & 32 else e[h, 1]
    val[h + 1, w + 1] = e[h + 1, w + 1] if avail & 64 else e[h, w]

    x0, x1, x2, x3 = val[:-1, :-1], val[:-1, 1:], val[1:, :-1], val[1:, 1:]
    y0, y1, y2, y3 = x0 + x2, x1 + x3, x0 - x2, x1 - x3
    t0, t1, t2, t3 = y0 + y1, y0 - y1, y2 + y3, y2 - y3
    ti = min(max(tbl_idx, 0), 4)
    thr_log2 = int(T.HTDF_THR_LOG2[ti])
    shift = thr_log2 - 4
    rnd = (1 << shift) >> 1
    thr = (1 << thr_log2) - (1 << shift)
    tbl_row = torch.as_tensor(T.HTDF_TBL[ti], dtype=_I32, device=dev)
    z1, z2, z3 = (_htdf_read_table(t, tbl_row, thr, shift, rnd)
                  for t in (t1, t2, t3))
    iy0, iy1, iy2, iy3 = t0 + z2, z1 + z3, t0 - z2, z1 - z3
    acc = torch.zeros((h + 2, w + 2), dtype=_I32, device=dev)
    acc[:-1, :-1] += (iy0 + iy1) >> 2
    acc[:-1, 1:] += (iy0 - iy1) >> 2
    acc[1:, :-1] += (iy2 + iy3) >> 2
    acc[1:, 1:] += (iy2 - iy3) >> 2
    return _clip((acc + 2) >> 2, (1 << bd) - 1)[1:h + 1, 1:w + 1]


def intra_scan_wave_ref(recs, resids, icu, level_off, bd, chroma):
    """Plain version of `intra_scan_wave` (in place on `recs`): levels in
    order; within a level, every CU's tiles from the planes as they were
    before the level, then the writes; then the level's HTDF tiles from
    the planes after those writes, then their writes
    (jax_intra_main.py:596-660)."""
    rec_y, rec_u, rec_v = recs
    res_y, res_u, res_v = resids
    rows = icu.cpu().tolist()
    offs = [int(v) for v in level_off]
    has_htdf = icu.shape[1] > 13
    for lo, hi in zip(offs[:-1], offs[1:]):
        level = rows[lo:hi]
        writes = []
        for c in level:
            x, y, lw, lh, ipm = (c[ICM_X], c[ICM_Y], c[ICM_LOG2W],
                                 c[ICM_LOG2H], c[ICM_IPM])
            masks = (c[ICM_UP], c[ICM_LEFT], c[ICM_RIGHT], c[ICM_CORNER],
                     c[ICM_LR])
            ok = c[ICM_VALID] == 1 and (
                c[ICM_DO_INTRA] if has_htdf else 1) == 1
            if ok and c[ICM_TREE] != 2:
                writes.append((rec_y, x, y, pred_tile_ref(
                    rec_y, res_y, x, y, lw, lh, ipm, *masks, 2, bd)))
            if ok and chroma and c[ICM_TREE] != 1:
                ipm_c = chroma_ipm_eff(ipm, c[ICM_IPM_C])
                for rec, res in ((rec_u, res_u), (rec_v, res_v)):
                    writes.append((rec, x >> 1, y >> 1, pred_tile_ref(
                        rec, res, x >> 1, y >> 1, lw - 1, lh - 1, ipm_c,
                        *masks, 1, bd)))
        _write(writes)
        if has_htdf:
            _write([(rec_y, c[ICM_X], c[ICM_Y], htdf_tile_ref(
                rec_y, c[ICM_X], c[ICM_Y], c[ICM_LOG2W], c[ICM_LOG2H],
                c[ICM_HTDF_AVAIL], c[ICM_HTDF_IDX], bd))
                for c in level
                if c[ICM_VALID] == 1 and c[ICM_HTDF_IDX] >= 0])
    return recs


def _write(writes):
    for plane, x, y, tile in writes:
        h, w = tile.shape
        plane[BORDER + y:BORDER + y + h, BORDER + x:BORDER + x + w] = tile


def intra_scan_wave(recs, resids, icu, level_off, bd, chroma, tables):
    """recs / resids: (y, u, v) bordered int16 planes (u/v unused when not
    `chroma`); icu: int32 [N, 13 or 16] EIPD scan table sorted by level
    (ops/pack.py `pack_intra_main`); level_off: int32 [L + 1] level
    offsets, a host array or CPU tensor (the launch schedule, read by the
    host loop); tables: `device_tables` of the planes' device.
    Reconstructs the CUs in place on `recs` and returns them."""
    rec_y, rec_u, rec_v = recs
    res_y, res_u, res_v = resids
    offs = torch.as_tensor(level_off)
    if offs.device.type != "cpu" or offs.dim() != 1:
        raise ValueError("level_off is the host launch schedule: a 1-D "
                         "host array")
    if rec_y.device.type == "cpu":
        return intra_scan_wave_ref(recs, resids, icu, offs, bd, chroma)
    offs = offs.to(torch.int32).contiguous()
    tab = tables["intra_main"]
    K.require(icu, torch.int32, 2, contiguous=True)
    K.require(tab, torch.int32, 1, contiguous=True)
    planes = [(rec_y, res_y)] + ([(rec_u, res_u), (rec_v, res_v)]
                                 if chroma else [])
    for rec, res in planes:
        K.require(rec, torch.int16, 2, contiguous=True)
        K.require(res, torch.int16, 2, contiguous=True)
        if rec.shape != res.shape:
            raise ValueError("intra_scan_wave: picture and residual planes "
                             f"differ in shape: {rec.shape} vs {res.shape}")
    if chroma and rec_u.shape != rec_v.shape:
        raise ValueError("intra_scan_wave: u and v planes differ in shape")
    if icu.shape[1] not in (13, 16):
        raise ValueError(f"EIPD CU table wants 13 or 16 columns, got "
                         f"{tuple(icu.shape)}")
    n_levels = offs.shape[0] - 1
    if n_levels < 0 or (n_levels and (int(offs[0]) != 0 or int(offs[-1])
                                      != icu.shape[0]
                                      or bool((offs[1:] < offs[:-1]).any()))):
        raise ValueError("level_off does not cover the CU table in order")
    if icu.shape[0] == 0:
        return recs
    lib = K.lib()
    K.count("intra_scan_wave")
    err = lib.xevd_intra_scan_wave(
        rec_y.data_ptr(), rec_u.data_ptr() if chroma else None,
        rec_v.data_ptr() if chroma else None, res_y.data_ptr(),
        res_u.data_ptr() if chroma else None,
        res_v.data_ptr() if chroma else None,
        rec_y.stride(0), rec_u.stride(0) if chroma else 0,
        icu.data_ptr(), icu.shape[1], offs.data_ptr(), n_levels,
        tab.data_ptr(), bd, int(chroma), K.stream_ptr(icu.device))
    K.check(err, "xevd_intra_scan_wave")
    return recs
