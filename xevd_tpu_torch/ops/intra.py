"""Baseline intra reconstruction in decode order (the port of K5
`intra_scan`, xevd_tpu/ops/jax_intra.py:113).

`intra_scan` updates the bordered picture planes in place: the CUDA kernel
(csrc/intra.cu, one launch per frame) for CUDA planes, `intra_scan_ref`
(a Python loop over CUs) for CPU planes.  With CUDA planes every operand,
the CU table included, must be on the card.  With `icu_off` it scans the G
frames of one time step of a GOP batch (K15) in one launch, one CTA a
frame (`intra_scan_batch_ref` on the CPU)."""
from __future__ import annotations

import torch

from ..host import tables as T

from ..kernels import build as K
from .tables import BORDER


def _cu_plane_ref(rec, res, x, y, log2, ipm, up_mask, left_mask, corner_f,
                  unit, bd):
    """One CU on one plane (ref: xevd_tpu/ops/jax_intra.py:70-109)."""
    dev = rec.device
    cuw = 1 << log2
    n2 = 2 * cuw
    mid = 1 << (bd - 1)
    by, bx = BORDER + y, BORDER + x
    units = torch.arange(n2, device=dev) // unit
    up_ok = ((up_mask & 0xFFFFFFFF) >> units) & 1 == 1
    left_ok = ((left_mask & 0xFFFFFFFF) >> units) & 1 == 1
    up = torch.where(up_ok, rec[by - 1, bx:bx + n2].to(torch.int32), mid)
    left = torch.where(left_ok, rec[by:by + n2, bx - 1].to(torch.int32), mid)
    ii = torch.arange(cuw, device=dev)[:, None]
    jj = torch.arange(cuw, device=dev)[None, :]
    if ipm == T.IPD_VER_B:
        pred = up[:cuw][None, :].expand(cuw, cuw)
    elif ipm == T.IPD_HOR_B:
        pred = left[:cuw][:, None].expand(cuw, cuw)
    elif ipm == T.IPD_DC_B:
        dc = (left[:cuw].sum() + up[:cuw].sum() + cuw) >> (log2 + 1)
        pred = dc.expand(cuw, cuw)
    elif ipm == T.IPD_UL_B:
        corner = (rec[by - 1, bx - 1].to(torch.int32) if corner_f == 1
                  else torch.tensor(mid, dtype=torch.int32, device=dev))
        d = ii - jj
        pred = torch.where(d > 0, left[(d - 1).clamp(0, n2 - 1)],
                           torch.where(d == 0, corner,
                                       up[(-d - 1).clamp(0, n2 - 1)]))
    else:
        k = ii + jj + 1
        pred = (up[k] + left[k]) >> 1
    t = (pred + res[by:by + cuw, bx:bx + cuw].to(torch.int32)).to(torch.int16)
    rec[by:by + cuw, bx:bx + cuw] = t.clamp(0, (1 << bd) - 1)


def intra_scan_ref(recs, resids, icu, bd, chroma):
    """Plain version of `intra_scan` (in place on `recs`)."""
    rec_y, rec_u, rec_v = recs
    res_y, res_u, res_v = resids
    for x, y, log2, ipm, upm, lem, cor, valid in icu.cpu().tolist():
        if valid != 1:
            continue
        _cu_plane_ref(rec_y, res_y, x, y, log2, ipm, upm, lem, cor, 4, bd)
        if chroma:
            for rec, res in ((rec_u, res_u), (rec_v, res_v)):
                _cu_plane_ref(rec, res, x >> 1, y >> 1, log2 - 1, ipm, upm,
                              lem, cor, 2, bd)
    return recs


def intra_scan_batch_ref(recs, resids, icu, icu_off, bd, chroma):
    """Plain version of the batched `intra_scan`: frame g (planes [g], rows
    icu[icu_off[g]:icu_off[g + 1]]) through `intra_scan_ref`."""
    off = icu_off.cpu().tolist()
    for g in range(len(off) - 1):
        intra_scan_ref([None if r is None else r[g] for r in recs],
                       [None if r is None else r[g] for r in resids],
                       icu[off[g]:off[g + 1]], bd, chroma)
    return recs


def intra_scan(recs, resids, icu, bd, chroma, icu_off=None):
    """recs / resids: (y, u, v) bordered int16 planes (u/v unused when not
    `chroma`); icu: int32 [N, 8] CU table in decode order (ops/pack.py).
    Reconstructs every valid CU in place on `recs` and returns them.  A GOP
    batch of G frames: planes [G, H, W] and `icu_off` int32 [G + 1], frame
    g's CUs at rows icu_off[g]:icu_off[g + 1]."""
    rec_y, rec_u, rec_v = recs
    res_y, res_u, res_v = resids
    batched = icu_off is not None
    if rec_y.device.type == "cpu":
        if batched:
            return intra_scan_batch_ref(recs, resids, icu, icu_off, bd,
                                        chroma)
        return intra_scan_ref(recs, resids, icu, bd, chroma)
    K.require(icu, torch.int32, 2, contiguous=True)
    if batched:
        K.require(icu_off, torch.int32, 1, contiguous=True)
    nd = 3 if batched else 2
    G = icu_off.shape[0] - 1 if batched else 1
    planes = [(rec_y, res_y)] + ([(rec_u, res_u), (rec_v, res_v)]
                                 if chroma else [])
    for rec, res in planes:
        K.require(rec, torch.int16, nd, contiguous=True)
        K.require(res, torch.int16, nd, contiguous=True)
        if batched and rec.shape[0] != G:
            raise ValueError(f"intra_scan: {rec.shape[0]} planes for {G} "
                             "frames")
        if rec.shape != res.shape:
            raise ValueError("intra_scan: picture and residual planes differ "
                             f"in shape: {rec.shape} vs {res.shape}")
    if chroma and rec_u.shape != rec_v.shape:
        raise ValueError("intra_scan: u and v planes differ in shape")
    if icu.shape[1] != 8:
        raise ValueError(f"CU table wants 8 columns, got {tuple(icu.shape)}")
    n = icu.shape[0]
    if n == 0:
        return recs
    lib = K.lib()
    K.count("intra_scan")
    err = lib.xevd_intra_scan(
        rec_y.data_ptr(), rec_u.data_ptr() if chroma else None,
        rec_v.data_ptr() if chroma else None, res_y.data_ptr(),
        res_u.data_ptr() if chroma else None,
        res_v.data_ptr() if chroma else None,
        rec_y.stride(-2), rec_u.stride(-2) if chroma else 0,
        icu.data_ptr(), n, bd, int(chroma),
        icu_off.data_ptr() if batched else None, G,
        rec_y.stride(0) if batched else 0,
        rec_u.stride(0) if batched and chroma else 0,
        K.stream_ptr(icu.device))
    K.check(err, "xevd_intra_scan")
    return recs
