"""PyTorch pixel backend: the device half of one frame, and the decoder seam.

`TorchPixelBackend` plugs into `xevd_tpu.decoder.Decoder(backend=...)` at
the same seam as the JAX package's `JaxPixelBackend`
(xevd_tpu/ops/pipeline.py:392).  Per frame: host pack (ops/pack.py), two
host->device copies, then `run_frame_device`:

  ITDQ (kernel: csrc/itdq.cu; Main iqt and ATS bases) -> MC of the inter
  CUs (csrc/mc.cu; Main ADMVP taps) -> recon with the prediction (Triton)
  -> intra: the Baseline scan (csrc/intra.cu), or with EIPD the wavefront
  scan with HTDF (csrc/intra_main.cu) -> deblock (csrc/deblock.cu) ->
  pad-expand (Triton)

The decoded picture planes stay on the device as DPB references
(DevicePlane); MC reads them there, and they reach the host only when the
writer reads them.  All of a frame's work is issued on the current CUDA
stream, so a frame's MC reads its references after the frames that wrote
them.

Scope: Baseline and Main profile, I, P and B frames (IPPP and RA), 4:2:0
or 4:0:0, 8 to 10 bit; of the Main tools eipd, btt, iqt, ats, admvp, hmvp,
mmvd, amvr, adcc, cm_init, htdf, dquant, rpl, pocs and dra (applied by the
host at pull time).  SUCO, ADDB, ALF, affine, IBC, DMVR, and BTT or HTDF
without EIPD raise UnsupportedStream at the SPS, before any pixel is
produced."""
from __future__ import annotations

import numpy as np

from xevd_tpu.syntax import UnsupportedStream

from ..device import resolve_device
from ..plane import DevicePlane
from . import pack as PK
from .deblock import deblock_frame
from .intra import intra_scan
from .intra_main import intra_scan_wave
from .itdq import itdq
from .mc import mc_all
from .recon import pad, recon
from .tables import BORDER, PAD_C, PAD_L, device_tables

STAGES = ("pack", "itdq", "mc", "recon", "intra", "deblock", "pad")


def residuals_and_recon(df: PK.DeviceFrame, tables: dict, mark=None):
    """ITDQ -> MC (frames with inter CUs) -> recon: (resids, recs), the
    bordered residual and picture planes (y, u, v; u, v None for 4:0:0)
    the intra stage starts from.  `mark(name)`, if given, is called after
    each stage."""
    mark = mark or (lambda name: None)
    pf = df.packed
    bd = pf.bd
    resids = itdq((df.coef_y, df.coef_u, df.coef_v), df.tus, pf.shp_y,
                  pf.shp_c, bd, tables, pf.iqt)
    mark("itdq")
    if pf.refs:
        pred_y, cnt_y, pred_u, pred_v, cnt_c = mc_all(
            df.mc, pf.mc_lists, pf.refs, pf.shp_y, pf.shp_c, bd, tables,
            pf.main_taps)
        preds = ((pred_y, cnt_y), (pred_u, cnt_c), (pred_v, cnt_c))
    else:
        preds = ((None, None),) * 3
    mark("mc")
    recs = tuple(None if r is None else recon(r, bd, *p)
                 for r, p in zip(resids, preds))
    mark("recon")
    return resids, recs


def run_frame_device(df: PK.DeviceFrame, tables: dict, on_stage=None):
    """Device half of one frame (xevd_tpu/ops/pipeline.py:334-376): ITDQ
    -> MC (frames with inter CUs) -> recon -> intra scan (the EIPD
    wavefront scan with HTDF when the frame has EIPD, else the Baseline
    scan) -> deblock -> padded picture planes (y, u, v) as int16 tensors
    (u, v None for 4:0:0).  `on_stage(name)`, if given, is called after
    each stage."""
    mark = on_stage or (lambda name: None)
    pf = df.packed
    bd, chroma = pf.bd, pf.chroma
    resids, recs = residuals_and_recon(df, tables, mark)
    if pf.eipd:
        intra_scan_wave(recs, resids, df.icu, pf.level_off, bd, chroma,
                        tables)
    else:
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
    """Bit-exact PyTorch + CUDA/Triton pixel pipeline (Baseline, and Main
    without SUCO, ADDB or ALF).

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
        bit-exactly; never emit wrong pixels.  Mirrors the JAX backend's
        refusals (xevd_tpu/ops/pipeline.py:434-460) and adds the Main
        tools whose kernels are not ported yet."""
        if getattr(sps, "is_main", False):
            for flag, what in (
                    ("sps_suco_flag", "SUCO (its chroma deblock order, "
                     "kernel K10) is not ported yet: ROADMAP M6"),
                    ("tool_addb", "ADDB (kernel K11) is not ported yet: "
                     "ROADMAP M7"),
                    ("tool_alf", "ALF (kernel K13) is not ported yet: "
                     "ROADMAP M8"),
                    ("tool_affine", "affine MC is not on the device path "
                     "(the JAX backend refuses it too)"),
                    ("ibc_flag", "IBC is not on the device path (the JAX "
                     "backend refuses it too)"),
                    ("tool_dmvr", "DMVR is not on the device path (the JAX "
                     "backend refuses it too)")):
                if getattr(sps, flag, 0):
                    raise UnsupportedStream(f"torch backend: Main stream with "
                                            f"{what}")
            if not sps.tool_eipd and (sps.sps_btt_flag or sps.tool_htdf):
                raise UnsupportedStream(
                    "torch backend: Main stream with BTT or HTDF but without "
                    "EIPD (the JAX backend refuses it too)")
        if sps.chroma_format_idc not in (0, 1):
            raise UnsupportedStream("torch backend: 4:2:0/4:0:0 only")
        bd = sps.bit_depth_luma_minus8 + 8
        if bd > 10 or (sps.chroma_format_idc
                       and sps.bit_depth_chroma_minus8 + 8 != bd):
            raise UnsupportedStream("torch backend: 8- to 10-bit streams "
                                    "with equal luma/chroma depth only")

    def pack_frame(self, job, sps, refp):
        """Host half of decode_frame."""
        return PK.pack_frame(job, sps, refp)

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
