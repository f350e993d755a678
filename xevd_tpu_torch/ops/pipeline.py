"""PyTorch pixel backend: the device half of one frame, and the decoder seam.

`TorchPixelBackend` plugs into `host.decoder.Decoder(backend=...)` at
the same seam as the JAX package's `JaxPixelBackend`
(xevd_tpu/ops/pipeline.py:392).  Per frame: host pack (ops/pack.py) into
a slot of the backend's staging ring (ops/staging.py), two host->device
copies issued from it, then `run_frame_device`:

  ITDQ (kernel: csrc/itdq.cu; Main iqt and ATS bases) -> MC of the inter
  CUs (csrc/mc.cu; Main ADMVP taps) -> recon with the prediction (Triton)
  -> intra: the Baseline scan (csrc/intra.cu), or with EIPD the wavefront
  scan with HTDF (csrc/intra_main.cu), each one persistent launch ->
  deblock (csrc/deblock.cu, with SUCO its ordered chroma pass; with ADDB
  csrc/addb.cu, one launch) -> ALF (csrc/alf.cu, one launch, into new
  planes) -> pad-expand (csrc/pad.cu, one launch over Y, U and V) of what
  ALF returns

The decoded picture planes stay on the device as DPB references
(DevicePlane); MC reads them there, and they reach the host only when the
writer reads them.  All of a frame's work, its copies included, is issued
on the current CUDA stream, so a frame's MC reads its references after
the frames that wrote them.  On the card `decode_frame` issues and
returns, as the JAX backend's does under asynchronous dispatch
(xevd_tpu/ops/pipeline.py:563-570): nothing in it waits for the device
(no blocking copy, no read of a device value; every launch size comes
from the pack), except `HostStaging.acquire` when the slot it hands out
still feeds a copy in flight.

`run_frames_device` is the same pipeline over the G frames of one time
step of a GOP batch (K15, the `jax.vmap` of xevd_tpu/parallel/gop.py:215-
218): one launch per kernel per step, whatever G; the decode of whole GOPs
around it is xevd_tpu_torch/parallel/gop.py.

Scope: Baseline and Main profile, I, P and B frames (IPPP and RA), 4:2:0
or 4:0:0, 8 to 10 bit; of the Main tools eipd, btt, suco, iqt, ats, admvp,
hmvp, mmvd, amvr, adcc, cm_init, htdf, addb, alf, dquant, rpl, pocs and
dra (applied by the host at pull time).  Affine, IBC, DMVR, and BTT or
HTDF without EIPD raise UnsupportedStream at the SPS, before any pixel is
produced, as the JAX backend refuses them."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..host.syntax import UnsupportedStream

from ..device import resolve_device
from ..kernels import build as K
from ..plane import DevicePlane
from . import pack as PK
from .addb import addb_frame
from .alf import alf_frame
from .deblock import deblock_frame
from .intra import intra_scan
from .intra_main import intra_scan_wave
from .itdq import itdq
from .mc import DpbRing, mc_all
from .recon import pad_picture, recon
from .staging import HostStaging
from .tables import BORDER, device_tables

STAGES = ("pack", "upload", "itdq", "mc", "recon", "intra", "deblock", "alf", "pad")
# the stages `run_frames_device` marks in a GOP batch step, in order
GOP_STAGES = ("itdq", "mc", "recon", "intra", "deblock", "pad")


def residuals_and_recon(df: PK.DeviceFrame, tables: dict, mark=None):
    """ITDQ -> MC (frames with inter CUs) -> recon: (resids, recs), the
    bordered residual and picture planes (y, u, v; u, v None for 4:0:0)
    the intra stage starts from.  `mark(name)`, if given, is called after
    each stage."""
    mark = mark or (lambda name: None)
    pf = df.packed
    bd = pf.bd
    resids = itdq((df.coef_y, df.coef_u, df.coef_v), df.tus, pf.shp_y,
                  pf.shp_c, bd, tables, pf.iqt, order=df.tu_order)
    mark("itdq")
    if pf.refs:
        pred_y, cnt_y, pred_u, pred_v, cnt_c = mc_all(
            df.mc, pf.mc_lists, pf.refs, pf.shp_y, pf.shp_c, bd, tables,
            pf.main_taps, order=df.mc_order)
        preds = ((pred_y, cnt_y), (pred_u, cnt_c), (pred_v, cnt_c))
    else:
        preds = ((None, None),) * 3
    mark("mc")
    recs = tuple(None if r is None else recon(r, bd, *p)
                 for r, p in zip(resids, preds))
    mark("recon")
    return resids, recs


def intra_stage(df: PK.DeviceFrame, recs, resids, tables: dict):
    """The intra scan in place on `recs`: the EIPD wavefront scan with HTDF
    when the frame has EIPD, else the Baseline scan."""
    pf = df.packed
    if pf.eipd:
        intra_scan_wave(recs, resids, df.icu, df.level_off, pf.bd,
                        pf.chroma, tables)
    else:
        intra_scan(recs, resids, df.icu, pf.bd, pf.chroma)


def frame_areas(df: PK.DeviceFrame, recs):
    """(y, u, v): the views of the bordered planes that deblock and ALF
    filter -- the SCU area, or with ADDB the H8 x W8 crop of its
    even-padded maps (xevd_tpu/ops/pipeline.py:260-261); u, v None for
    4:0:0."""
    pf = df.packed
    if pf.addb:
        H4, W4 = df.addb_l.shape[1] * 4, df.addb_l.shape[2] * 4
    else:
        H4, W4 = pf.geom[2] * 4, pf.geom[3] * 4
    y = recs[0][BORDER:BORDER + H4, BORDER:BORDER + W4]
    if not pf.chroma:
        return y, None, None
    return (y,) + tuple(r[BORDER:BORDER + (H4 >> 1), BORDER:BORDER + (W4 >> 1)]
                        for r in recs[1:])


def deblock_stage(df: PK.DeviceFrame, areas):
    """Deblock in place on the areas: ADDB, or the Baseline filter with the
    SUCO chroma order when the frame has one, or nothing."""
    pf = df.packed
    if pf.addb:
        addb_frame(*areas, df.addb_l, df.addb_c, pf.bd)
    elif pf.deblock_on:
        deblock_frame(*areas, df.dbst, pf.bd,
                      (df.suco_off, df.suco_edges, df.suco_runs) if pf.suco
                      else None)


def alf_stage(df: PK.DeviceFrame, areas):
    """ALF, when the frame has it: returns the (y, u, v) planes pad reads
    (on the card, ALF's new output planes where it filtered; else the
    areas)."""
    pf = df.packed
    if pf.alf is None:
        return areas
    return alf_frame(*areas, df.alf_l, df.alf_c, df.alf_on, pf.geom[0],
                     pf.geom[1], pf.alf, pf.bd)


def run_frame_device(df: PK.DeviceFrame, tables: dict, on_stage=None):
    """Device half of one frame (xevd_tpu/ops/pipeline.py:334-389): ITDQ
    -> MC (frames with inter CUs) -> recon -> intra scan (the EIPD
    wavefront scan with HTDF when the frame has EIPD, else the Baseline
    scan) -> deblock (ADDB, or the Baseline filter with the SUCO chroma
    order when the frame has one) -> ALF -> padded picture planes (y, u, v)
    as int16 tensors (u, v None for 4:0:0).  `on_stage(name)`, if given,
    is called after each stage."""
    mark = on_stage or (lambda name: None)
    pf = df.packed
    resids, recs = residuals_and_recon(df, tables, mark)
    intra_stage(df, recs, resids, tables)
    mark("intra")
    areas = frame_areas(df, recs)
    deblock_stage(df, areas)
    mark("deblock")
    y_area, u_area, v_area = alf_stage(df, areas)
    mark("alf")
    pics = pad_picture(y_area, u_area, v_area, pf.geom[0], pf.geom[1],
                       pf.chroma)
    mark("pad")
    return pics


@dataclass
class DpbStep:
    """The device DPB as one step of a GOP batch sees it: `refs`, the DPB
    ring at this step (ops/mc.py `DpbRing`; the MC table's slots name its
    pictures); `out`, the (y, u, v) planes [G, h + 2 PAD, w + 2 PAD] that
    receive the step's padded pictures."""
    refs: DpbRing
    out: tuple


def run_frames_device(batch: PK.DeviceBatch, tables: dict, dpb: DpbStep,
                      on_stage=None):
    """Device half of the G frames of one time step of a GOP batch: ITDQ
    -> MC (steps with inter blocks) -> recon -> Baseline intra scan (the
    frames' CU rows interleaved by the batch's ticket order, so their
    chains run side by side) -> Baseline deblock -> pad-expand into
    `dpb.out`, each a single launch over the batch (a launch per plane for
    recon and the chroma passes, as for one frame; pad one launch over Y,
    U and V).  Frames of one step share size, bit depth and frame flags
    (ops/pack.py `stack_frames`).  `on_stage(name)`, if given, is called
    after each stage (GOP_STAGES).  Returns dpb.out."""
    mark = on_stage or (lambda name: None)
    pb = batch.packed
    bd, chroma = pb.bd, pb.chroma
    if batch.tus.is_cuda:
        K.count("gop_step")         # K15: one batched step on the card
    resids = itdq((batch.coef_y, batch.coef_u, batch.coef_v), batch.tus,
                  pb.shp_y, pb.shp_c, bd, tables, pb.iqt, tu_off=batch.tu_off,
                  order=batch.tu_order)
    mark("itdq")
    if batch.mc.shape[0]:
        pred_y, cnt_y, pred_u, pred_v, cnt_c = mc_all(
            batch.mc, pb.mc_lists, dpb.refs, pb.shp_y, pb.shp_c, bd, tables,
            pb.main_taps, mc_off=batch.mc_off, order=batch.mc_order)
        preds = ((pred_y, cnt_y), (pred_u, cnt_c), (pred_v, cnt_c))
    else:
        preds = ((None, None),) * 3
    mark("mc")
    recs = tuple(None if r is None else recon(r, bd, *p)
                 for r, p in zip(resids, preds))
    mark("recon")
    intra_scan(recs, resids, batch.icu, bd, chroma, icu_off=batch.icu_off,
               order=batch.icu_order)
    mark("intra")
    h, w, h_scu, w_scu = pb.geom
    H4, W4 = h_scu * 4, w_scu * 4
    areas = [recs[0][:, BORDER:BORDER + H4, BORDER:BORDER + W4]]
    if chroma:
        areas += [r[:, BORDER:BORDER + (H4 >> 1), BORDER:BORDER + (W4 >> 1)]
                  for r in recs[1:]]
    else:
        areas += [None, None]
    if pb.deblock_on:
        deblock_frame(*areas, batch.dbst, bd)
    mark("deblock")
    pad_picture(*areas, h, w, chroma, out=dpb.out)
    mark("pad")
    return dpb.out


class TorchPixelBackend:
    """Bit-exact PyTorch + CUDA/Triton pixel pipeline (Baseline, and Main
    with the tools the JAX backend decodes).

    device: "cuda" (kernels) or "cpu" (plain PyTorch versions; tests).
    on_stage: optional callback, called with "start" when a frame begins
    and with each name of STAGES when that stage has been issued ("pack"
    after the host pack into a staging slot, the wait for the slot
    included; "upload" after its two host->device copies were issued).
    `staging`: the ring of host buffers each frame is packed into
    (ops/staging.py; two slots, the JAX backend's double buffer)."""

    name = "torch"
    device_resident = True

    def __init__(self, device="cuda", on_stage=None):
        self.device = resolve_device(device)
        self.tables = device_tables(self.device)
        self.on_stage = on_stage
        self.staging = HostStaging(self.device)

    def check_caps(self, sps):
        """Refuse, at the SPS, every stream the port cannot decode
        bit-exactly; never emit wrong pixels.  Mirrors the JAX backend's
        refusals (xevd_tpu/ops/pipeline.py:434-460) and its in-pack ones
        (chroma format, bit depth)."""
        if getattr(sps, "is_main", False):
            for flag, what in (
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
        """Host half of decode_frame: the pack into the next slot of the
        staging ring, once the copies it last fed have ended.  The frame
        views its slot until the ring comes round to it again: whoever
        keeps it keeps `pf.copy()`."""
        slot = self.staging.acquire(coef_count=PK.coef_count(
            job.fs, sps.chroma_format_idc == 1))
        return PK.pack_frame(job, sps, refp, slot=slot)

    def decode_frame(self, job, sps, refp):
        """Pack the frame into a staging slot, issue its copies and its
        device half, and return its padded picture planes (device
        tensors, still being computed on a card)."""
        mark = self.on_stage or (lambda name: None)
        mark("start")
        pf = self.pack_frame(job, sps, refp)
        mark("pack")
        df = PK.upload(pf, self.device)
        mark("upload")
        return run_frame_device(df, self.tables, self.on_stage)

    def make_picture_planes(self, rec_planes, fs, sps):
        # decode_frame already produced the padded picture planes
        return tuple(None if t is None else DevicePlane(t)
                     for t in rec_planes)

    def to_host(self, plane):
        return np.asarray(plane)
