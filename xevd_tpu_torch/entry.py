"""A single step of the decoder's device work on the port's kernels: the
counterpart of `__graft_entry__.entry()` (__graft_entry__.py:7-43).

    fn, args = entry("cuda")       # or entry("cpu"): the plain versions
    rec = fn(*args)

The step is the JAX entry's 128x128 8-bit frame step: one 16x16 Baseline
ITDQ bucket of 16 TUs through `ops/itdq.py` `itdq` (the K1/K2 kernel with
its class order on the card, `itdq_ref` on the CPU), scattered into the
int16 residual plane; recon of the prediction plus the residual with the
int16 wrap and the clip to 0..255 (K4); and both luma deblock passes in
`ops/deblock.py` `deblock_luma` (K8).  The inputs are drawn from
`np.random.default_rng(0)` in the order of __graft_entry__.py:30-38, so
`coef`, `scales`, `pos` and `pred` equal the JAX entry's.  The strength
maps differ in shape: JAX's example draws them per sample row or column
(st_ver [H, W/4], st_hor [H/4, W]), K8 takes them per SCU ([H/4, W/4],
the only kind a stream produces), so these are drawn per SCU; JAX's
layout of the same maps is np.repeat(st_ver, 4, axis=0) and
np.repeat(st_hor, 4, axis=1)."""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops import pack as PK
from .ops.deblock import deblock_luma
from .ops.itdq import itdq
from .ops.recon import recon
from .ops.tables import BORDER, PAD_R, device_tables

H = W = 128
BIT_DEPTH = 8
N_TU = 16
LOG2 = 4                      # the bucket's 16x16 TUs


def entry(device="cuda"):
    """Returns (fn, example_args): fn(coef, scales, pos, pred, st_ver,
    st_hor) -> the deblocked picture, int16 [H, W].  coef int32 [16, 16,
    16] (values within int16, as the decoder's coefficients), scales int32
    [16], pos int32 [16, 2] (the TUs' top-left y, x, inside the picture),
    pred int32 [H, W], st_ver and st_hor int32 [H/4, W/4] per-SCU
    strengths; all on `device`."""
    dev = resolve_device(device)
    tables = device_tables(dev)
    shp = (BORDER + H + PAD_R, BORDER + W + PAD_R)
    # every TU is of one class (16x16, Baseline): the kernel's class order
    # is the same for any coefficients, positions and scales
    tus0 = np.zeros((N_TU, PK.TU_COLS), np.int32)
    tus0[:, PK.TU_LOG2W] = tus0[:, PK.TU_LOG2H] = LOG2
    o = PK.itdq_order(tus0, False)
    order = PK.ItdqOrder(torch.from_numpy(o.order).to(dev),
                         torch.from_numpy(o.classes).to(dev), o.n_cta, o.smem)
    s = 1 << LOG2
    ar = torch.arange(s, device=dev)
    cnt = torch.zeros(shp, dtype=torch.int8, device=dev)
    cnt[BORDER:BORDER + H, BORDER:BORDER + W] = 1

    def frame_step(coef, scales, pos, pred, st_ver, st_hor):
        # ITDQ of the bucket: its blocks on a coefficient plane, a TU table
        yy = pos[:, 0, None, None] + ar[None, :, None]
        xx = pos[:, 1, None, None] + ar[None, None, :]
        plane = torch.zeros((H, W), dtype=torch.int16, device=dev)
        plane[yy, xx] = coef.to(torch.int16)
        zero = torch.zeros_like(scales)
        tus = torch.stack([zero, zero + LOG2, zero + LOG2, scales, pos[:, 0],
                           pos[:, 1], zero], 1).to(torch.int32).contiguous()
        resid, _, _ = itdq((plane, None, None), tus, shp, None, BIT_DEPTH,
                           tables, order=order)
        # recon: the prediction plus the residual, wrapped through int16,
        # clipped to 0..255
        pred_b = torch.zeros(shp, dtype=torch.int32, device=dev)
        pred_b[BORDER:BORDER + H, BORDER:BORDER + W] = pred
        rec = recon(resid, BIT_DEPTH, pred_b, cnt)
        area = rec[BORDER:BORDER + H, BORDER:BORDER + W]
        deblock_luma(area, st_ver, st_hor, BIT_DEPTH)
        return area

    rng = np.random.default_rng(0)
    coef = rng.integers(-500, 500, size=(N_TU, s, s))
    scales = np.full(N_TU, 1280)
    pos = np.array([[(i // 8) * s, (i % 8) * s] for i in range(N_TU)])
    pred = rng.integers(0, 255, size=(H, W))
    st_ver = rng.integers(0, 2, size=(H // 4, W // 4)) * 4
    st_hor = rng.integers(0, 2, size=(H // 4, W // 4)) * 4
    args = tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                 for a in (coef, scales, pos, pred, st_ver, st_hor))
    return frame_step, args
