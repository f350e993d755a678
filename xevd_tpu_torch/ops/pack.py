"""Host half of one frame: the per-frame syntax tensors as one flat payload.

JAX-free port of `_Packer`, `_pack_itdq` and `_pack_intra`
(xevd_tpu/ops/pipeline.py:79-116, 580-675, 813-833) for the Baseline
all-intra slice.  What the JAX version does only to keep jit signatures
stable is gone: no pow2 bucket padding, no pad rows at 1<<20, no per-size
buckets.  The TU table is one list that the ITDQ kernel walks in a single
launch.

Per frame there is one int32 payload and one int16 coefficient buffer, so
two host->device copies.  Both are fresh host arrays: the native entropy
engine reuses its coefficient scratch two slices later
(xevd_tpu/ops/pipeline.py:483-488), and `torch.from_numpy` aliases."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from xevd_tpu import tables as T
from xevd_tpu.syntax import UnsupportedStream

from .tables import BORDER, PAD_R

# TU table columns (one row per transform unit)
TU_COMP, TU_LOG2W, TU_LOG2H, TU_SCALE, TU_Y, TU_X = range(6)
# CU table columns of the Baseline intra scan (xevd_tpu/ops/pipeline.py:825)
CU_X, CU_Y, CU_LOG2, CU_IPM, CU_UP, CU_LEFT, CU_CORNER, CU_VALID = range(8)


class Packer:
    """Flat int32 payload assembler; `layout` maps name -> (offset, shape)."""

    def __init__(self):
        self.chunks = []
        self.layout = {}
        self.off = 0

    def add(self, name: str, arr: np.ndarray):
        arr = np.ascontiguousarray(arr, dtype=np.int32)
        self.layout[name] = (self.off, arr.shape)
        self.chunks.append(arr.ravel())
        self.off += arr.size

    def finish(self):
        if not self.chunks:
            return np.zeros(0, np.int32), dict(self.layout)
        return np.concatenate(self.chunks), dict(self.layout)


def pack_itdq(fs, bd: int, chroma: bool) -> np.ndarray:
    """TU table int32 [N, 6]: (comp, log2w, log2h, scale, y, x) for every
    coded block with cbf set; chroma coordinates are in chroma samples."""
    if np.any(fs.cu_ats[:, 0] != 0) or np.any(fs.cu_ats[:, 2] != 0):
        raise UnsupportedStream("torch backend: ATS transforms are Main only")
    coded = fs.cu_pred_mode != T.MODE_SKIP
    qps = (fs.cu_qp + 6 * (bd - 8), fs.cu_qp_u, fs.cu_qp_v)
    planes = (fs.coef_y, fs.coef_u, fs.coef_v)
    rows = []
    for comp in ((0, 1, 2) if chroma else (0,)):
        idx = np.nonzero(coded & (fs.cu_cbf[:, comp] != 0))[0]
        s = 1 if comp else 0
        qp = np.asarray(qps[comp])[idx].astype(np.int64)
        r = np.empty((len(idx), 6), np.int32)
        r[:, TU_COMP] = comp
        r[:, TU_LOG2W] = fs.cu_log2w[idx] - s
        r[:, TU_LOG2H] = fs.cu_log2h[idx] - s
        r[:, TU_SCALE] = T.DQ_SCALE_B[qp % 6].astype(np.int64) << (qp // 6)
        r[:, TU_Y] = fs.cu_y[idx] >> s
        r[:, TU_X] = fs.cu_x[idx] >> s
        if (r[:, TU_LOG2W:TU_LOG2H + 1] < 1).any() or \
                (r[:, TU_LOG2W:TU_LOG2H + 1] > 6).any():
            raise ValueError("TU size outside 2..64")
        hp, wp = planes[comp].shape
        if ((r[:, TU_Y] + (1 << r[:, TU_LOG2H].astype(np.int64)) > hp).any()
                or (r[:, TU_X] + (1 << r[:, TU_LOG2W].astype(np.int64))
                    > wp).any()):
            raise ValueError("TU outside its coefficient plane")
        rows.append(r)
    return np.concatenate(rows)


def pack_intra(fs, job) -> np.ndarray:
    """CU table int32 [N, 8] of the intra scan, in decode order:
    (x, y, log2, ipm, up_mask, left_mask, corner, valid).  The masks are
    uint32 bitfields carried as int32 (xevd_tpu/ops/pipeline.py:827-830)."""
    idx = np.nonzero(fs.cu_pred_mode == T.MODE_INTRA)[0]
    if (fs.cu_log2w[idx] != fs.cu_log2h[idx]).any():
        raise UnsupportedStream("torch Baseline intra kernel: square CUs only")
    if (fs.cu_log2w[idx] < 2).any() or (fs.cu_log2w[idx] > 6).any():
        raise ValueError("intra CU size outside 4..64")
    size = 1 << fs.cu_log2w[idx].astype(np.int64)
    if ((fs.cu_x[idx] + size > fs.w_pad).any()
            or (fs.cu_y[idx] + size > fs.h_pad).any()):
        # the neighbour reads (up to 2 CU widths) then stay in the border
        raise ValueError("intra CU outside the CTU-padded picture")

    def u32(v):
        return (np.asarray(v) & 0xFFFFFFFF).astype(np.uint32).astype(np.int32)

    return np.stack(
        [fs.cu_x[idx], fs.cu_y[idx], fs.cu_log2w[idx], fs.cu_ipm[idx],
         u32(job.cu_nbr_up[idx]), u32(job.cu_nbr_left[idx]),
         job.cu_nbr_corner[idx].astype(np.int32),
         np.ones(len(idx), np.int32)], 1).astype(np.int32)


@dataclass
class PackedFrame:
    """Everything the device half of one frame needs, on the host."""
    payload: np.ndarray          # int32, see `layout`
    layout: dict                 # name -> (offset, shape)
    coefs: np.ndarray            # int16: coef_y then coef_u, coef_v, flat
    coef_shapes: tuple           # ((h, w) luma, (h, w) chroma or None)
    bd: int
    chroma: bool
    deblock_on: bool
    geom: tuple                  # (h, w, h_scu, w_scu)
    shp_y: tuple                 # bordered working plane shapes
    shp_c: tuple | None


@dataclass
class DeviceFrame:
    """A PackedFrame after its host->device copies (views into two
    device buffers)."""
    tus: torch.Tensor            # int32 [Nt, 6]
    icu: torch.Tensor            # int32 [Nc, 8]
    dbst: torch.Tensor | None    # int32 [6, h_scu, w_scu]
    coef_y: torch.Tensor         # int16 [h_pad, w_pad]
    coef_u: torch.Tensor | None
    coef_v: torch.Tensor | None
    packed: PackedFrame


def pack_frame(job, sps) -> PackedFrame:
    """Build the payload of one Baseline all-intra frame; refuse the rest."""
    fs = job.fs
    bd = sps.bit_depth_luma_minus8 + 8
    cfi = sps.chroma_format_idc
    if cfi not in (0, 1):
        raise UnsupportedStream("torch backend: 4:2:0/4:0:0 only")
    if (fs.cu_pred_mode != T.MODE_INTRA).any():
        raise UnsupportedStream("torch backend: inter CUs are not ported yet "
                                "(Baseline all-intra frames only)")
    if job.alf_param is not None:
        raise UnsupportedStream("torch backend: ALF is Main only")
    if getattr(job, "addb_luma", None) is not None:
        raise UnsupportedStream("torch backend: ADDB is Main only")
    chroma = cfi == 1
    deblock_on = bool(fs.sh.deblocking_filter_on)

    pk = Packer()
    pk.add("tus", pack_itdq(fs, bd, chroma))
    pk.add("icu", pack_intra(fs, job))
    if deblock_on:
        dbst = np.stack([job.db_ver_y, job.db_hor_y, job.db_ver_u,
                         job.db_hor_u, job.db_ver_v, job.db_hor_v])
        if dbst.shape[1:] != (fs.h_scu, fs.w_scu):
            raise ValueError(f"deblock strength maps {dbst.shape[1:]} != "
                             f"SCU grid {(fs.h_scu, fs.w_scu)}")
        pk.add("dbst", dbst)
    payload, layout = pk.finish()

    planes = [fs.coef_y] + ([fs.coef_u, fs.coef_v] if chroma else [])
    coefs = np.concatenate([np.asarray(p, np.int16).ravel() for p in planes])
    shp_y = (BORDER + fs.h_pad + PAD_R, BORDER + fs.w_pad + PAD_R)
    shp_c = ((BORDER + (fs.h_pad >> 1) + PAD_R,
              BORDER + (fs.w_pad >> 1) + PAD_R) if chroma else None)
    return PackedFrame(
        payload=payload, layout=layout, coefs=coefs,
        coef_shapes=(fs.coef_y.shape,
                     fs.coef_u.shape if chroma else None),
        bd=bd, chroma=chroma, deblock_on=deblock_on,
        geom=(fs.h, fs.w, fs.h_scu, fs.w_scu), shp_y=shp_y, shp_c=shp_c)


def upload(pf: PackedFrame, device: torch.device) -> DeviceFrame:
    """Two host->device copies; every table is a view into them."""
    payload = torch.from_numpy(pf.payload).to(device)
    coefs = torch.from_numpy(pf.coefs).to(device)

    def view(name):
        if name not in pf.layout:
            return None
        off, shape = pf.layout[name]
        return payload[off:off + int(np.prod(shape))].view(shape)

    (hy, wy), shc = pf.coef_shapes
    coef_y = coefs[:hy * wy].view(hy, wy)
    coef_u = coef_v = None
    if pf.chroma:
        hc, wc = shc
        n = hc * wc
        coef_u = coefs[hy * wy:hy * wy + n].view(hc, wc)
        coef_v = coefs[hy * wy + n:hy * wy + 2 * n].view(hc, wc)
    return DeviceFrame(tus=view("tus"), icu=view("icu"), dbst=view("dbst"),
                       coef_y=coef_y, coef_u=coef_u, coef_v=coef_v,
                       packed=pf)
