"""Reconstruction and pad-expand (the port of K4 `_recon_plane` /
`_recon_all`, xevd_tpu/ops/pipeline.py:221-238, and K14 `_pad_out`,
xevd_tpu/ops/pipeline.py:241).

CUDA tensors launch the Triton recon kernel of ops/recon_triton.py and the
CUDA pad kernel of csrc/pad.cu (`pad_picture`: one launch over a picture's
Y, U and V); CPU tensors take the `*_ref` plain versions.  Both take the
planes of a GOP batch (K15) with a leading G, in one launch: recon is
elementwise, pad has G in its grid."""
from __future__ import annotations

import array

import torch

from ..kernels import build as K
from .tables import PAD_C, PAD_L


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


def _pad_shape(area, h, w, pad, out):
    """The output shape (a tuple of ints) of padding area[..., :h, :w] by
    `pad`; raises on a crop outside the area or an `out` of another
    shape."""
    *lead, H, W = area.shape
    if not (0 < h <= H and 0 < w <= W) or len(lead) > 1:
        raise ValueError(f"pad: crop {h}x{w} outside area {tuple(area.shape)}")
    shape = (*lead, h + 2 * pad, w + 2 * pad)
    if out is not None and out.shape != shape:
        raise ValueError(f"pad: out {tuple(out.shape)} != {shape}")
    return shape


def pad_picture(y_area, u_area, v_area, h, w, chroma, out=None):
    """K14, the port of `_pad_out` (xevd_tpu/ops/pipeline.py:241): the
    picture y_area[..., :h, :w] padded by PAD_L and, with `chroma`, u_area
    and v_area[..., :h/2, :w/2] by PAD_C; areas int16 [H, W] (views with a
    row pitch are fine) or the [G, H, W] of a GOP batch step.  `out`: the
    (y, u, v) planes to write (rows contiguous; the DPB's), or None for new
    ones.  Returns (pic_y, pic_u, pic_v), u and v None for 4:0:0.  CUDA
    tensors: one launch of csrc/pad.cu over every plane; a picture's pad
    takes some 6 us on the card, so the host work is kept to a few tensor
    calls a plane."""
    out = out or (None, None, None)
    planes = [(y_area, h, w, PAD_L, out[0])]
    if chroma:
        planes += [(a, h >> 1, w >> 1, PAD_C, o)
                   for a, o in zip((u_area, v_area), out[1:])]
    if y_area.device.type == "cpu":
        for p in planes:
            _pad_shape(*p)
        pics = [pad_ref(a, ph, pw, p) if o is None else o.copy_(
            pad_ref(a, ph, pw, p)) for a, ph, pw, p, o in planes]
        return tuple(pics) if chroma else (pics[0], None, None)
    nd = y_area.dim()
    G = y_area.shape[0] if nd == 3 else 1
    pics, desc = [], array.array("q")
    for a, ph, pw, p, o in planes:
        K.require(a, torch.int16, nd, rows_contiguous=True)
        shape = _pad_shape(a, ph, pw, p, o)
        if nd == 3 and shape[0] != G:
            raise ValueError("pad: planes of different batch sizes")
        if o is None:
            o = torch.empty(shape, dtype=torch.int16, device=a.device)
        else:
            K.require(o, torch.int16, nd, rows_contiguous=True)
        pics.append(o)
        desc.extend((a.data_ptr(), o.data_ptr(), a.stride(-2), o.stride(-2),
                     a.stride(0) if nd == 3 else 0,
                     o.stride(0) if nd == 3 else 0, ph, pw, p))
    K.count("pad")
    err = K.lib().xevd_pad_picture(desc.buffer_info()[0], len(planes), G,
                                   K.stream_ptr(y_area.device))
    K.check(err, "xevd_pad_picture")
    return tuple(pics) if chroma else (pics[0], None, None)
