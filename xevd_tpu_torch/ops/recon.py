"""Reconstruction and pad-expand (the port of K4 `_recon_plane` /
`_recon_all`, xevd_tpu/ops/pipeline.py:221-238, and K14 `_pad_out`,
xevd_tpu/ops/pipeline.py:241).

CUDA tensors launch the Triton kernels of ops/recon_triton.py; CPU tensors
take the `*_ref` plain versions."""
from __future__ import annotations

import torch

from ..kernels import build as K


def recon_ref(resid, bd):
    """clip(resid, 0, 2^bd - 1): K4's recon with the zero prediction of an
    intra frame, whose CUs the intra scan predicts later
    (ref: xevd_tpu/ops/pipeline.py:221-225 with pred = cnt = 0)."""
    return resid.clamp(0, (1 << bd) - 1)


def pad_ref(area, h, w, pad):
    """Edge-replicate area[:h, :w] by `pad` on every side."""
    dev = area.device
    rows = (torch.arange(h + 2 * pad, device=dev) - pad).clamp(0, h - 1)
    cols = (torch.arange(w + 2 * pad, device=dev) - pad).clamp(0, w - 1)
    return area[rows[:, None], cols[None, :]]


def recon(resid, bd):
    """resid int16 [H, W] of an intra frame; returns a new int16 plane.
    The prediction of inter frames (K4 `_mc_all`) comes with the MC port."""
    if resid.device.type == "cpu":
        return recon_ref(resid, bd)
    K.require(resid, torch.int16, 2, contiguous=True)
    from . import recon_triton
    out = torch.empty_like(resid)
    K.count("recon")
    recon_triton.launch_recon(resid, out, bd)
    return out


def pad(area, h, w, pad):
    """area int16 [H, W] (a view with a row pitch is fine), h <= H,
    w <= W; returns a new int16 [h + 2 pad, w + 2 pad] plane."""
    if not (0 < h <= area.shape[0] and 0 < w <= area.shape[1]):
        raise ValueError(f"pad: crop {h}x{w} outside area {tuple(area.shape)}")
    if area.device.type == "cpu":
        return pad_ref(area, h, w, pad)
    K.require(area, torch.int16, 2, rows_contiguous=True)
    from . import recon_triton
    out = torch.empty((h + 2 * pad, w + 2 * pad), dtype=torch.int16,
                      device=area.device)
    K.count("pad")
    recon_triton.launch_pad(area, out, h, w, pad)
    return out
