"""PyTorch pixel backend: the device half of one frame, and the decoder seam.

`TorchPixelBackend` plugs into `xevd_tpu.decoder.Decoder(backend=...)` at
the same seam as the JAX package's `JaxPixelBackend`
(xevd_tpu/ops/pipeline.py:392).  Per frame: host pack (ops/pack.py), two
host->device copies, then `run_frame_device`:

  ITDQ (kernel: csrc/itdq.cu) -> recon (Triton) -> intra scan
  (csrc/intra.cu) -> deblock (csrc/deblock.cu) -> pad-expand (Triton)

The decoded picture planes stay on the device as DPB references
(DevicePlane); they reach the host only when the writer reads them.

Scope: Baseline profile, all-intra frames, 4:2:0 or 4:0:0, 8 to 10 bit.
Everything else raises UnsupportedStream before any pixel is produced."""
from __future__ import annotations

import numpy as np

from xevd_tpu.syntax import UnsupportedStream

from ..device import resolve_device
from ..plane import DevicePlane
from . import pack as PK
from .deblock import deblock_frame
from .intra import intra_scan
from .itdq import itdq
from .recon import pad, recon
from .tables import BORDER, PAD_C, PAD_L, device_tables

STAGES = ("pack", "itdq", "recon", "intra", "deblock", "pad")


def run_frame_device(df: PK.DeviceFrame, tables: dict, on_stage=None):
    """Device half of one frame: ITDQ -> recon -> intra scan -> deblock ->
    padded picture planes (y, u, v) as int16 tensors (u, v None for
    4:0:0).  `on_stage(name)`, if given, is called after each stage."""
    mark = on_stage or (lambda name: None)
    pf = df.packed
    bd, chroma = pf.bd, pf.chroma
    resids = itdq((df.coef_y, df.coef_u, df.coef_v), df.tus, pf.shp_y,
                  pf.shp_c, bd, tables)
    mark("itdq")
    recs = tuple(None if r is None else recon(r, bd) for r in resids)
    mark("recon")
    intra_scan(recs, resids, df.icu, bd, chroma)
    mark("intra")
    h, w, h_scu, w_scu = pf.geom
    H4, W4 = h_scu * 4, w_scu * 4
    y_area = recs[0][BORDER:BORDER + H4, BORDER:BORDER + W4]
    u_area = v_area = None
    if chroma:
        u_area = recs[1][BORDER:BORDER + (H4 >> 1), BORDER:BORDER + (W4 >> 1)]
        v_area = recs[2][BORDER:BORDER + (H4 >> 1), BORDER:BORDER + (W4 >> 1)]
    if pf.deblock_on:
        deblock_frame(y_area, u_area, v_area, df.dbst, bd)
    mark("deblock")
    pic_y = pad(y_area, h, w, PAD_L)
    pic_u = pic_v = None
    if chroma:
        pic_u = pad(u_area, h >> 1, w >> 1, PAD_C)
        pic_v = pad(v_area, h >> 1, w >> 1, PAD_C)
    mark("pad")
    return pic_y, pic_u, pic_v


class TorchPixelBackend:
    """Bit-exact PyTorch + CUDA/Triton Baseline all-intra pixel pipeline.

    device: "cuda" (kernels) or "cpu" (plain PyTorch versions; tests).
    on_stage: optional callback, called with "start" when a frame begins
    and with each name of STAGES when that stage has been issued."""

    name = "torch"
    device_resident = True

    def __init__(self, device="cuda", on_stage=None):
        self.device = resolve_device(device)
        self.tables = device_tables(self.device)
        self.on_stage = on_stage

    def check_caps(self, sps):
        """Refuse, at the SPS, every stream the port cannot decode
        bit-exactly; never emit wrong pixels."""
        if getattr(sps, "is_main", False):
            raise UnsupportedStream("torch backend: Main profile is not "
                                    "ported yet (Baseline only)")
        if sps.chroma_format_idc not in (0, 1):
            raise UnsupportedStream("torch backend: 4:2:0/4:0:0 only")
        bd = sps.bit_depth_luma_minus8 + 8
        if bd > 10 or (sps.chroma_format_idc
                       and sps.bit_depth_chroma_minus8 + 8 != bd):
            raise UnsupportedStream("torch backend: 8- to 10-bit streams "
                                    "with equal luma/chroma depth only")

    def pack_frame(self, job, sps, refp=None):
        """Host half of decode_frame (refuses inter frames)."""
        return PK.pack_frame(job, sps)

    def decode_frame(self, job, sps, refp):
        mark = self.on_stage or (lambda name: None)
        mark("start")
        df = PK.upload(self.pack_frame(job, sps, refp), self.device)
        mark("pack")
        return run_frame_device(df, self.tables, self.on_stage)

    def make_picture_planes(self, rec_planes, fs, sps):
        # decode_frame already produced the padded picture planes
        return tuple(None if t is None else DevicePlane(t)
                     for t in rec_planes)

    def to_host(self, plane):
        return np.asarray(plane)
