"""Reconstruction and pad-expand (the port of K4 `_recon_plane` /
`_recon_all`, xevd_tpu/ops/pipeline.py:221-238, and K14 `_pad_out`,
xevd_tpu/ops/pipeline.py:241).

CUDA tensors launch the Triton kernels of ops/recon_triton.py; CPU tensors
take the `*_ref` plain versions.  Both take the planes of a GOP batch
(K15) with a leading G, in one launch: recon is elementwise, pad has G in
its grid."""
from __future__ import annotations

import torch

from ..kernels import build as K


def recon_ref(resid, bd, pred=None, cnt=None):
    """K4's recon (ref: xevd_tpu/ops/pipeline.py:221-225): the prediction,
    averaged ((p + 1) >> 1) where both lists predicted (cnt == 2), plus the
    residual, wrapped through int16, clipped to [0, 2^bd - 1].  Without
    `pred` (an intra frame, whose CUs the intra scan predicts later) the
    prediction is zero: a clip of the residual."""
    if pred is None:
        return resid.clamp(0, (1 << bd) - 1)
    p = torch.where(cnt == 2, (pred + 1) >> 1, pred)
    t = (p + resid.to(torch.int32)).to(torch.int16)
    return t.clamp(0, (1 << bd) - 1)


def pad_ref(area, h, w, pad):
    """Edge-replicate area[..., :h, :w] by `pad` on every side."""
    dev = area.device
    rows = (torch.arange(h + 2 * pad, device=dev) - pad).clamp(0, h - 1)
    cols = (torch.arange(w + 2 * pad, device=dev) - pad).clamp(0, w - 1)
    return area[..., rows[:, None], cols[None, :]]


def recon(resid, bd, pred=None, cnt=None):
    """resid int16 [H, W], or [G, H, W] for a GOP batch; pred int32 and cnt
    int8 of the same shape (from ops/mc.py `mc_all`), or both None for an
    intra frame; returns a new int16 plane."""
    if (pred is None) != (cnt is None):
        raise ValueError("recon: pred and cnt come together")
    if resid.device.type == "cpu":
        return recon_ref(resid, bd, pred, cnt)
    nd = resid.dim()
    if nd not in (2, 3):
        raise ValueError(f"recon: plane of shape {tuple(resid.shape)}")
    K.require(resid, torch.int16, nd, contiguous=True)
    if pred is not None:
        K.require(pred, torch.int32, nd, contiguous=True)
        K.require(cnt, torch.int8, nd, contiguous=True)
        if pred.shape != resid.shape or cnt.shape != resid.shape:
            raise ValueError("recon: pred, cnt and resid differ in shape")
    from . import recon_triton
    out = torch.empty_like(resid)
    K.count("recon")
    recon_triton.launch_recon(resid, out, bd, pred, cnt)
    return out


def pad(area, h, w, pad, out=None):
    """area int16 [H, W], or [G, H, W] for a GOP batch (a view with a row
    pitch is fine), h <= H, w <= W; returns the int16 [h + 2 pad, w + 2
    pad] plane(s): `out` (rows contiguous; e.g. DPB slots), or new ones."""
    if not (0 < h <= area.shape[-2] and 0 < w <= area.shape[-1]) \
            or area.dim() not in (2, 3):
        raise ValueError(f"pad: crop {h}x{w} outside area {tuple(area.shape)}")
    shape = area.shape[:-2] + (h + 2 * pad, w + 2 * pad)
    if out is not None and tuple(out.shape) != tuple(shape):
        raise ValueError(f"pad: out {tuple(out.shape)} != {tuple(shape)}")
    if area.device.type == "cpu":
        if out is None:
            return pad_ref(area, h, w, pad)
        return out.copy_(pad_ref(area, h, w, pad))
    K.require(area, torch.int16, area.dim(), rows_contiguous=True)
    if out is None:
        out = torch.empty(shape, dtype=torch.int16, device=area.device)
    K.require(out, torch.int16, area.dim(), rows_contiguous=True)
    from . import recon_triton
    K.count("pad")
    recon_triton.launch_pad(area, out, h, w, pad)
    return out
