"""Dequant + inverse transform of every TU of a frame, scattered into
bordered residual planes (the port of K1 `itdq_bucket`,
xevd_tpu/ops/jax_itdq.py:47, fused with K2 `_itdq_all`,
xevd_tpu/ops/pipeline.py:143).

`itdq` launches the CUDA kernel (csrc/itdq.cu) once per frame for CUDA
coefficient planes and runs `itdq_ref`, the plain PyTorch version, for CPU
ones.  Three variants, as in the JAX version: the Baseline DCT-2 with an
exact wide second stage (ref: xevd_tpu/ops/ref_numpy.itdq_block); the Main
DCT-2 (`iqt`) and the ATS DST-7/DCT-8 bases (a TU's `trs`), whose two
stages each clip to 16 bits (xevd_tpu/ops/jax_itdq.py:75-95).  With
`tu_off` it runs the G frames of one time step of a GOP batch (K15) in the
same single launch (`itdq_batch_ref` on the CPU)."""
from __future__ import annotations

import torch

from ..host import tables as T

from ..kernels import build as K
from .pack import (TU_COLS, TU_COMP, TU_LOG2H, TU_LOG2W, TU_SCALE, TU_TRS,
                   TU_X, TU_Y, ItdqOrder)
from .tables import BORDER, MAX_TX_VAL, MIN_TX_VAL

S32_MAX = 2 ** 31 - 1
# elements of the largest int64 broadcast product the plain version builds
_REF_CHUNK = 1 << 22


def dequant_params(log2_w: int, log2_h: int, bd: int):
    """(ns_scale, shift, offset) of the Baseline dequant
    (ref: xevd_tpu/ops/ref_numpy.py:28-33)."""
    odd = (log2_w + log2_h) & 1
    log2_size = (log2_w + log2_h) >> 1
    tr_shift = T.MAX_TX_DYNAMIC_RANGE - bd - log2_size
    shift = T.QUANT_IQUANT_SHIFT - T.QUANT_SHIFT - tr_shift + (8 if odd else 0)
    return (181 if odd else 1), shift, (0 if shift == 0 else 1 << (shift - 1))


def basis(tables: dict, log2: int, kind: int = -1) -> torch.Tensor:
    """The n-point basis as int64 [n (frequency), n (sample)]: kind -1 the
    DCT-2, sliced from the 64-point one as the kernel does; 0 the DST-7,
    1 the DCT-8 (ATS, n <= 32)."""
    n = 1 << log2
    if kind < 0:
        return tables["tm64"][::64 >> log2, :n].to(torch.int64)
    return tables["tr"][kind, log2, :n, :n].to(torch.int64)


def _new_planes(shp_y, shp_c, device, lead=()):
    res_y = torch.zeros(lead + shp_y, dtype=torch.int16, device=device)
    if shp_c is None:
        return res_y, None, None
    return (res_y, torch.zeros(lead + shp_c, dtype=torch.int16, device=device),
            torch.zeros(lead + shp_c, dtype=torch.int16, device=device))


def itdq_blocks_ref(coef: torch.Tensor, scale: torch.Tensor, log2_w: int,
                    log2_h: int, bd: int, tables: dict, iqt: bool = False,
                    trs: int = 0) -> torch.Tensor:
    """coef [N, h, w] (any int dtype), scale [N] -> int16 residual [N, h, w].
    All arithmetic in int64, the dequant clipped to int16.  Baseline:
    stage 0 clipped to s32, stage 1 with its combined shift, clipped to
    [MIN_TX_VAL, MAX_TX_VAL].  Main (`iqt` or `trs`): stage 0 rounded by
    64, shifted by 7 and clipped to int16, stage 1 shifted by 20 - bd and
    clipped; `trs` = ((th + 1) << 2) | (tv + 1) takes the DST-7 (0) or
    DCT-8 (1) basis for the width (th) and height (tv) axes."""
    ns, shift, offset = dequant_params(log2_w, log2_h, bd)
    c = coef.to(torch.int64)
    m = (scale.to(torch.int64) * ns)[:, None, None]
    dq = ((c * m + offset) >> shift).clamp(-32768, 32767)
    main = bool(iqt or trs)
    kind_w, kind_h = ((trs >> 2) - 1, (trs & 3) - 1) if trs else (-1, -1)
    tm_h = basis(tables, log2_h, kind_h)      # [v (freq), y (spatial)]
    tm_w = basis(tables, log2_w, kind_w)      # [u (freq), x (spatial)]
    shift2 = 20 - bd if main else 7 + 12 - (bd - 8)
    h, w = dq.shape[1:]
    out = torch.empty(dq.shape, dtype=torch.int16, device=dq.device)
    step = max(1, _REF_CHUNK // max(h * h * w, h * w * w))
    for i in range(0, dq.shape[0], step):
        d = dq[i:i + step]
        # stage 0: s0[n, y, u] = sum_v tm_h[v, y] * dq[n, v, u]
        s0 = (tm_h.t()[None, :, :, None] * d[:, None, :, :]).sum(2)
        if main:
            s0 = ((s0 + 64) >> 7).clamp(-32768, 32767)
        else:
            s0 = s0.clamp(-S32_MAX, S32_MAX)
        # stage 1: r[n, y, x] = sum_u s0[n, y, u] * tm_w[u, x]
        r = (s0[:, :, :, None] * tm_w[None, None, :, :]).sum(2)
        r = ((r + (1 << (shift2 - 1))) >> shift2).clamp(MIN_TX_VAL, MAX_TX_VAL)
        out[i:i + step] = r.to(torch.int16)
    return out


def itdq_ref(coefs, tus, shp_y, shp_c, bd, tables, iqt=False):
    """Plain version of `itdq`: TUs grouped by (comp, log2w, log2h, trs),
    each group gathered, transformed and scattered with tensor ops."""
    dev = coefs[0].device
    planes = _new_planes(shp_y, shp_c, dev)
    rows = tus.cpu()
    if rows.shape[0] == 0:
        return planes
    keys = (rows[:, TU_COMP] * 4096 + rows[:, TU_TRS] * 256
            + rows[:, TU_LOG2W] * 16 + rows[:, TU_LOG2H])
    for key in torch.unique(keys).tolist():
        comp, trs, lw, lh = key >> 12, (key >> 8) & 15, (key >> 4) & 15, \
            key & 15
        sel = rows[(keys == key).nonzero()[:, 0]].to(dev)
        h, w = 1 << lh, 1 << lw
        yy = sel[:, TU_Y, None, None] + torch.arange(h, device=dev)[
            None, :, None]
        xx = sel[:, TU_X, None, None] + torch.arange(w, device=dev)[
            None, None, :]
        blk = coefs[comp][yy, xx]
        res = itdq_blocks_ref(blk, sel[:, TU_SCALE], lw, lh, bd, tables, iqt,
                              trs)
        planes[comp][yy + BORDER, xx + BORDER] = res
    return planes


def itdq_batch_ref(coefs, tus, tu_off, shp_y, shp_c, bd, tables,
                   iqt=False):
    """Plain version of the batched `itdq`: frame g of the batch (its
    planes coefs[i][g], its rows tus[tu_off[g]:tu_off[g + 1]]) through
    `itdq_ref`; returns [G, ...] residual planes."""
    off = tu_off.cpu().tolist()
    outs = [itdq_ref([None if c is None else c[g] for c in coefs],
                     tus[off[g]:off[g + 1]], shp_y, shp_c, bd, tables, iqt)
            for g in range(len(off) - 1)]
    return tuple(None if outs[0][i] is None
                 else torch.stack([o[i] for o in outs]) for i in range(3))


def itdq(coefs, tus, shp_y, shp_c, bd, tables, iqt=False, tu_off=None,
         order: ItdqOrder | None = None):
    """coefs: (coef_y, coef_u, coef_v) int16 planes (u/v None for 4:0:0);
    tus: int32 [N, 7] TU table (ops/pack.py), whose trs column picks the
    ATS bases; `iqt`: the Main DCT-2 for every TU of the frame.  Returns
    bordered int16 residual planes of shapes shp_y / shp_c (zero where no
    TU).  A GOP batch of G frames: coefficient planes [G, h, w], `tu_off`
    int32 [G + 1] (frame g's TUs are rows tu_off[g]:tu_off[g + 1]), and
    residual planes [G, ...].  `order`: the kernel's launch over the TUs
    by size class (ops/pack.py `itdq_order`, on the device as the pack
    uploads it, built with the same `iqt`), which CUDA planes need; the
    plain version needs none."""
    if coefs[0].device.type == "cpu":
        if tu_off is not None:
            return itdq_batch_ref(coefs, tus, tu_off, shp_y, shp_c, bd,
                                  tables, iqt)
        return itdq_ref(coefs, tus, shp_y, shp_c, bd, tables, iqt)
    return _itdq_cuda(coefs, tus, shp_y, shp_c, bd, tables, tu_off, order)


def _itdq_cuda(coefs, tus, shp_y, shp_c, bd, tables, tu_off, order):
    coef_y, coef_u, coef_v = coefs
    tm64, tr = tables["tm64"], tables["tr"]
    batched = tu_off is not None
    K.require(tus, torch.int32, 2, contiguous=True)
    K.require(tm64, torch.int32, 2, contiguous=True)
    K.require(tr, torch.int32, 4, contiguous=True)
    if batched:
        K.require(tu_off, torch.int32, 1, contiguous=True)
    if order is None:
        raise ValueError("itdq: the kernel needs the TUs' class order "
                         "(ops/pack.py itdq_order)")
    K.require(order.order, torch.int32, 2, contiguous=True)
    K.require(order.classes, torch.int32, 2, contiguous=True)
    if order.order.shape != (tus.shape[0], 2) or order.classes.shape[1] != 4:
        raise ValueError(f"itdq: class order {tuple(order.order.shape)} / "
                         f"{tuple(order.classes.shape)} for "
                         f"{tus.shape[0]} TUs")
    for c in coefs:
        if c is not None:
            K.require(c, torch.int16, 3 if batched else 2,
                      rows_contiguous=True)
    if tus.shape[1] != TU_COLS:
        raise ValueError(f"TU table wants {TU_COLS} columns, got "
                         f"{tuple(tus.shape)}")
    G = tu_off.shape[0] - 1 if batched else 1
    if batched and coef_y.shape[0] != G:
        raise ValueError(f"itdq: {coef_y.shape[0]} coefficient planes for "
                         f"{G} frames")
    res_y, res_u, res_v = _new_planes(shp_y, shp_c, coef_y.device,
                                      (G,) if batched else ())
    n = tus.shape[0]
    if n == 0:
        return res_y, res_u, res_v
    chroma = shp_c is not None

    def bs(t):
        return t.stride(0) if batched and t is not None else 0
    lib = K.lib()
    K.count("itdq")
    err = lib.xevd_itdq(
        coef_y.data_ptr(), coef_u.data_ptr() if chroma else None,
        coef_v.data_ptr() if chroma else None,
        coef_y.stride(-2), coef_u.stride(-2) if chroma else 0,
        res_y.data_ptr(), res_u.data_ptr() if chroma else None,
        res_v.data_ptr() if chroma else None,
        res_y.stride(-2), res_u.stride(-2) if chroma else 0,
        tus.data_ptr(), order.order.data_ptr(), order.classes.data_ptr(),
        order.classes.shape[0], order.n_cta, order.smem, tm64.data_ptr(),
        tr.data_ptr(), bd, bs(coef_y), bs(coef_u if chroma else None),
        bs(res_y), bs(res_u if chroma else None), K.stream_ptr(tus.device))
    K.check(err, "xevd_itdq")
    return res_y, res_u, res_v
