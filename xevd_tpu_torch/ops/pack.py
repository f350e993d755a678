"""Host half of one frame: the per-frame syntax tensors as one flat payload.

JAX-free port of `_Packer`, `_pack_itdq`, `_pack_mc`, `_pack_intra`,
`_pack_intra_main` and `_chroma_ver_waves` (xevd_tpu/ops/pipeline.py:79-116,
580-927) and of the ADDB and ALF parts of `JaxPixelBackend.pack_frame`
(:505-517, 538-546) for Baseline and Main intra and inter frames.  What the JAX version does only to keep
jit signatures stable is gone: no pow2 bucket padding, no pad rows at
1<<20, no per-size or per-(size, case) buckets, no per-size-class
wavefront slots.  The TU table and the MC block table are one list each,
which the ITDQ kernel walks in a single launch and the MC kernel in one
launch per reference list; the EIPD scan table is one list sorted by
wavefront level, with the level offsets beside it; the SUCO chroma edges
are one list sorted by SCU row and rank, with row offsets (no waves).

Per frame there is one int32 payload and one int16 coefficient buffer, so
two host->device copies.  Both are fresh host arrays: the native entropy
engine reuses its coefficient scratch two slices later
(xevd_tpu/ops/pipeline.py:483-488), and `torch.from_numpy` aliases."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..host import tables as T
from ..host.syntax import UnsupportedStream

from ..plane import DevicePlane
from .tables import BORDER, PAD_C, PAD_L, PAD_R

# TU table columns (one row per transform unit); trs is 0 for DCT-2, else
# ((horizontal + 1) << 2) | (vertical + 1) with 0 = DST-7, 1 = DCT-8 per
# axis (xevd_tpu/ops/jax_itdq.py:47-54)
TU_COMP, TU_LOG2W, TU_LOG2H, TU_SCALE, TU_Y, TU_X, TU_TRS = range(7)
TU_COLS = 7
# CU table columns of the Baseline intra scan (xevd_tpu/ops/pipeline.py:825)
CU_X, CU_Y, CU_LOG2, CU_IPM, CU_UP, CU_LEFT, CU_CORNER, CU_VALID = range(8)
# CU table columns of the EIPD scan (xevd_tpu/ops/pipeline.py:862-872):
# 13, or 16 when the frame has HTDF work (do_intra, htdf_idx, htdf_avail)
(ICM_X, ICM_Y, ICM_LOG2W, ICM_LOG2H, ICM_IPM, ICM_IPM_C, ICM_UP, ICM_LEFT,
 ICM_RIGHT, ICM_CORNER, ICM_LR, ICM_TREE, ICM_VALID, ICM_DO_INTRA,
 ICM_HTDF_IDX, ICM_HTDF_AVAIL) = range(16)
# MC block table columns (one row per inter CU, reference list and plane
# group): plane (0 luma, 1 chroma u and v), block w, h, filter case
# (0 = 00, 1 = N0, 2 = 0N, 3 = NN), reference slot, position gx, gy in
# 1/16 (luma) or 1/32 (chroma) pel from the padded reference origin, the
# block's top-left py, px in the bordered planes, reference list
(MC_PLANE, MC_W, MC_H, MC_CASE, MC_SLOT, MC_GX, MC_GY, MC_PY, MC_PX,
 MC_LIST) = range(10)
MAX_REF_SLOTS = 32      # the MC kernel's pointer table (csrc/mc.cu)
# SUCO chroma edge columns: x of the edge in chroma samples, strength in U
# and in V (xevd_tpu/ops/jax_deblock.py:134-136 without the row, which the
# row offsets give)
SE_COL, SE_ST_U, SE_ST_V = range(3)


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


def _ats_trs(a_cu, a_mode):
    """The trs code of an ATS (cu, mode) pair, 0 where ATS is off
    (xevd_tpu/ops/pipeline.py:604-606)."""
    a_mode = np.asarray(a_mode, np.int64)
    return np.where(np.asarray(a_cu) != 0,
                    (((a_mode >> 1) + 1) << 2) | ((a_mode & 1) + 1), 0)


def pack_itdq(fs, bd: int, chroma: bool, iqt: bool = False,
              main: bool = False) -> np.ndarray:
    """TU table int32 [N, 7]: (comp, log2w, log2h, scale, y, x, trs) for
    every coded block with cbf set; chroma coordinates are in chroma
    samples.  Port of `_pack_itdq` (xevd_tpu/ops/pipeline.py:580-675):
    with `iqt` the scale comes from DQ_SCALE, else DQ_SCALE_B; intra ATS
    sets a luma TU's trs; an ATS-inter CU gives one sub-TU per component,
    its size, offset and (luma) trs from `host.tables.ats_inter_*`,
    its coefficients read at the sub-TU's own position.  ATS is a Main
    tool: a Baseline (`main` False) frame with ATS is refused."""
    if not main and (np.any(fs.cu_ats[:, 0] != 0)
                     or np.any(fs.cu_ats[:, 2] != 0)):
        raise UnsupportedStream("torch backend: ATS transforms are Main only")
    coded = fs.cu_pred_mode != T.MODE_SKIP
    ats = np.asarray(fs.cu_ats)
    dq = T.DQ_SCALE if iqt else T.DQ_SCALE_B
    qps = (fs.cu_qp + 6 * (bd - 8), fs.cu_qp_u, fs.cu_qp_v)
    planes = (fs.coef_y, fs.coef_u, fs.coef_v)
    rows = []
    for comp in ((0, 1, 2) if chroma else (0,)):
        idx = np.nonzero(coded & (fs.cu_cbf[:, comp] != 0))[0]
        s = 1 if comp else 0
        qp = np.asarray(qps[comp])[idx].astype(np.int64)
        r = np.empty((len(idx), TU_COLS), np.int64)
        r[:, TU_COMP] = comp
        r[:, TU_LOG2W] = fs.cu_log2w[idx] - s
        r[:, TU_LOG2H] = fs.cu_log2h[idx] - s
        r[:, TU_SCALE] = dq[qp % 6].astype(np.int64) << (qp // 6)
        r[:, TU_Y] = fs.cu_y[idx] >> s
        r[:, TU_X] = fs.cu_x[idx] >> s
        r[:, TU_TRS] = _ats_trs(ats[idx, 0], ats[idx, 1]) if comp == 0 else 0
        for j in np.nonzero(ats[idx, 2] != 0)[0]:  # ATS-inter sub-TUs
            info = int(ats[idx[j], 2])
            lw, lh = int(r[j, TU_LOG2W]), int(r[j, TU_LOG2H])
            ltw, lth = T.ats_inter_tu_size(info, lw, lh)
            xo, yo = T.ats_inter_tu_offset(info, lw, lh)
            r[j, TU_LOG2W], r[j, TU_LOG2H] = ltw, lth
            r[j, TU_X] += xo
            r[j, TU_Y] += yo
            r[j, TU_TRS] = (_ats_trs(*T.ats_inter_trs(info, lw, lh))
                            if comp == 0 else 0)
        size = r[:, TU_LOG2W:TU_LOG2H + 1]
        if (size < 1).any() or (size > 6).any():
            raise ValueError("TU size outside 2..64")
        if ((r[:, TU_TRS] != 0) & (size.max(1) > 5)).any():
            raise ValueError("ATS TU with a side of 64: the DST-7/DCT-8 "
                             "bases stop at 32")
        hp, wp = planes[comp].shape
        if ((r[:, TU_Y] + (1 << r[:, TU_LOG2H]) > hp).any()
                or (r[:, TU_X] + (1 << r[:, TU_LOG2W]) > wp).any()):
            raise ValueError("TU outside its coefficient plane")
        rows.append(r)
    return np.concatenate(rows).astype(np.int32)


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


def pack_intra_main(fs, job, chroma: bool):
    """(table, level_off): the EIPD scan table int32 [N, 13] (columns
    ICM_*), or [N, 16] when the frame has HTDF work, whose rows then also
    hold the HTDF-only inter CUs; rows sorted by wavefront level (a stable
    sort, so decode order within a level), and int32 [L + 1] level offsets
    (rows of level l are table[level_off[l]:level_off[l + 1]]).

    Port of `_pack_intra_main` (xevd_tpu/ops/pipeline.py:836-881).  The
    levels come from `host.ops.wavefront.level_scan_cus` (host code,
    native C when built).  CUs of one level touch disjoint pixels, so the
    sorted table is the same schedule as `group_wavefront`'s slots, without
    their padding.  Raises UnsupportedStream for a CU larger than 64, and
    ValueError for a CU whose neighbour or HTDF ring reads would leave the
    bordered plane: the kernel reads without clamping."""
    from ..host.ops.wavefront import level_scan_cus

    intra = fs.cu_pred_mode == T.MODE_INTRA
    htdf_any = (job.cu_htdf_idx is not None
                and bool((job.cu_htdf_idx >= 0).any()))
    sel = intra | (job.cu_htdf_idx >= 0) if htdf_any else intra
    idx = np.nonzero(sel)[0]
    ncol = 16 if htdf_any else 13
    if len(idx) == 0:
        return np.zeros((0, ncol), np.int32), np.zeros(1, np.int32)
    lw = fs.cu_log2w[idx].astype(np.int64)
    lh = fs.cu_log2h[idx].astype(np.int64)
    if (lw > 6).any() or (lh > 6).any():
        raise UnsupportedStream("torch EIPD kernel: intra CU > 64 "
                                "unsupported")
    if (lw < 2).any() or (lh < 2).any():
        raise ValueError("EIPD CU side below 4")
    x = fs.cu_x[idx].astype(np.int64)
    y = fs.cu_y[idx].astype(np.int64)
    if ((x < 0).any() or (y < 0).any() or (x + (1 << lw) > fs.w_pad).any()
            or (y + (1 << lh) > fs.h_pad).any()):
        # then every read (up to w + h samples along a side, the HTDF
        # ring) stays in the 72 / 136-px borders
        raise ValueError("EIPD CU outside the CTU-padded picture")

    def u32(v):
        return (np.asarray(v) & 0xFFFFFFFF).astype(np.uint32).astype(np.int32)

    cols = [x, y, lw, lh, fs.cu_ipm[idx], fs.cu_ipm_c[idx],
            u32(job.cu_nbr_up[idx]), u32(job.cu_nbr_left[idx]),
            u32(job.cu_nbr_right[idx]), job.cu_nbr_corner[idx],
            job.cu_avail_lr[idx], fs.cu_tree[idx], np.ones(len(idx))]
    if htdf_any:
        cols += [intra[idx], job.cu_htdf_idx[idx], job.cu_htdf_avail[idx]]
    rows = np.stack([np.asarray(c).astype(np.int64) for c in cols],
                    1).astype(np.int32)
    levels = np.asarray(level_scan_cus(fs, job, idx, chroma=chroma))
    order = np.argsort(levels, kind="stable")
    counts = np.bincount(levels, minlength=int(levels.max()) + 1)
    level_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return np.ascontiguousarray(rows[order]), level_off


def chroma_ver_edges(fs, job):
    """(row_off, edges) of the SUCO-order chroma vertical-edge pass, or None
    when the frame has no such edge: edges int32 [E, 3] (columns SE_*),
    the edges of SCU row r at edges[row_off[r]:row_off[r + 1]] in the
    order the pass filters them; row_off int32 [h_scu + 1].

    Port of `_chroma_ver_waves` (xevd_tpu/ops/pipeline.py:884-927): the
    replay of the per-CU deblock visit with the pass-local coded map
    (ref: src_base/xevd_df.c:388-545).  There, wave k holds the edge of rank
    k of each row; here each row lists its edges by rank, which is the
    order of the cascade within the row (rows never interact)."""
    h_scu, w_scu = fs.h_scu, fs.w_scu
    w, h = fs.w, fs.h
    h_scu_max = (h + 3) >> 2
    cod = np.zeros((h_scu, w_scu), np.uint8)
    dvu, dvv = job.db_ver_u, job.db_ver_v
    rows, edges = [], []
    for i in range(fs.num_cus()):
        x0, y0 = fs.cu_x[i], fs.cu_y[i]
        cuw = 1 << fs.cu_log2w[i]
        cuh = 1 << fs.cu_log2h[i]
        xs_, ys_ = x0 >> 2, y0 >> 2
        scuw, scuh = cuw >> 2, cuh >> 2
        if fs.cu_tree[i] != 1:  # do_chroma
            cands = []
            if 0 < x0 < w and cod[ys_, xs_ - 1]:
                cands.append(xs_)
            if x0 + cuw < w and xs_ + scuw < w_scu and cod[ys_, xs_ + scuw]:
                cands.append(xs_ + scuw)
            for xp in cands:
                for ys in range(ys_, min(ys_ + scuh, h_scu_max)):
                    su = int(dvu[ys, xp])
                    sv = int(dvv[ys, xp])
                    if su or sv:
                        rows.append(ys)
                        edges.append((xp * 2, su, sv))
        cod[ys_:ys_ + scuh, xs_:xs_ + scuw] = 1
    if not edges:
        return None
    rows = np.asarray(rows, np.int64)
    order = np.argsort(rows, kind="stable")     # rank order within a row
    row_off = np.concatenate(
        [[0], np.cumsum(np.bincount(rows, minlength=h_scu))]).astype(np.int32)
    edges = np.asarray(edges, np.int32)[order]
    if (rows >= h_scu).any() or (edges[:, SE_COL] < 2).any() \
            or (edges[:, SE_COL] > 2 * w_scu - 2).any():
        # the filter reads 2 samples a side, without clamping
        raise ValueError("SUCO chroma edge outside the chroma area")
    return row_off, np.ascontiguousarray(edges)


def addb_maps(fs, job):
    """(luma [2, hs2, ws2, 4], chroma [2, hs2, ws2, 7]) int32: the per-SCU
    ADDB parameter maps ([0] vertical, [1] horizontal edges; luma (bs,
    alpha, beta, c1), chroma (bs, alpha, beta, c0 of U, alpha, beta, c0 of
    V)), padded to an even SCU count with bs = 0 so the covered area is a
    multiple of 8 px (xevd_tpu/ops/pipeline.py:505-517)."""
    hs2 = (fs.h_scu + 1) & ~1
    ws2 = (fs.w_scu + 1) & ~1
    luma = np.zeros((2, hs2, ws2, 4), np.int32)
    luma[:, :fs.h_scu, :fs.w_scu] = job.addb_luma
    chroma = np.zeros((2, hs2, ws2, 7), np.int32)
    chroma[:, :fs.h_scu, :fs.w_scu] = job.addb_chroma
    return luma, chroma


def alf_params(fs, job):
    """(coef_l int32 [25, 13], coef_c int32 [7], ctu_on int32 [n_ctu],
    (enables, log2_ctu, across)) of an ALF frame
    (xevd_tpu/ops/pipeline.py:538-546, jax_alf.py:233-240): the final
    coefficients from the host oracle's reconstruction (host/ops/alf.py);
    chroma coefficients are zero when neither chroma plane is filtered."""
    from ..host.ops.alf import recon_coef_chroma, recon_coef_luma
    log2_ctu, across = job.alf_misc
    enables = tuple(bool(e) for e in job.alf_enable)
    coef_l = recon_coef_luma(job.alf_param)
    coef_c = (recon_coef_chroma(job.alf_param) if enables[1] or enables[2]
              else np.zeros(7, np.int32))
    n_ctu = (((fs.w + (1 << log2_ctu) - 1) >> log2_ctu)
             * ((fs.h + (1 << log2_ctu) - 1) >> log2_ctu))
    ctu_on = np.asarray(fs.alf_ctu_on, np.int32).ravel()
    if ctu_on.size < n_ctu:
        raise ValueError(f"ALF CTU flags: {ctu_on.size} < {n_ctu} CTUs")
    return coef_l, coef_c, ctu_on[:n_ctu], (enables, int(log2_ctu),
                                            bool(across))


def _ref_tensor(plane) -> torch.Tensor:
    if not isinstance(plane, DevicePlane):
        raise TypeError("reference picture plane is not a DevicePlane: the "
                        "torch backend predicts only from its own pictures")
    return plane.t


def pack_mc(fs, job, refp, chroma):
    """(table, lists, refs): the MC block table int32 [N, 10] (columns
    MC_*), the rows of list 0 first; lists = (rows of list 0, rows of list
    1); the reference planes, one (y, u, v) tensor tuple per slot (u, v
    None for 4:0:0).

    Port of `_pack_mc` (xevd_tpu/ops/pipeline.py:678-799): MV clip, the
    identical-motion skip, the (list, refi) -> slot map.  The filter case
    comes from the MV before clipping, the position from the clipped MV
    (ref: src_base/xevd_mc.c:435-557).  Raises ValueError when a block or
    its filter window, taps included, would leave its plane: the kernel
    reads without clamping."""
    idx = np.nonzero(fs.cu_pred_mode != T.MODE_INTRA)[0]
    if len(idx) == 0:
        return np.zeros((0, 10), np.int32), (0, 0), ()
    x = fs.cu_x[idx].astype(np.int64)
    y = fs.cu_y[idx].astype(np.int64)
    lw = fs.cu_log2w[idx].astype(np.int64)
    lh = fs.cu_log2h[idx].astype(np.int64)
    if (lw < 2).any() or (lw > 6).any() or (lh < 2).any() or (lh > 6).any():
        raise ValueError("inter CU size outside 4..64")
    cuw, cuh = 1 << lw, 1 << lh
    if (x + cuw > fs.w_pad).any() or (y + cuh > fs.h_pad).any():
        raise ValueError("inter CU outside the CTU-padded picture")
    refi = job.cu_refi[idx]                        # [M, 2]
    mv = job.cu_mv[idx].astype(np.int64)           # [M, 2, 2]

    # MV clip (ref: src_base/xevd_mc.c:435-467)
    x4, y4 = (x << 2)[:, None], (y << 2)[:, None]
    w4, h4 = (cuw << 2)[:, None], (cuh << 2)[:, None]
    lo = -(T.MAX_CU_SIZE << 2)
    hix = (fs.w - 1 + T.MAX_CU_SIZE) << 2
    hiy = (fs.h - 1 + T.MAX_CU_SIZE) << 2
    mvx, mvy = mv[:, :, 0], mv[:, :, 1]
    mvx_c = np.where(x4 + mvx < lo, lo - x4, mvx)
    mvy_c = np.where(y4 + mvy < lo, lo - y4, mvy)
    mvx_c = np.where(x4 + mvx + w4 - 4 > hix, hix - x4 - w4 + 4, mvx_c)
    mvy_c = np.where(y4 + mvy + h4 - 4 > hiy, hiy - y4 - h4 + 4, mvy_c)

    # identical motion in both lists is predicted once
    # (ref: src_base/xevd_mc.c:512-519)
    valid = refi >= 0
    used = sorted({(lidx, int(r)) for lidx in range(2)
                   for r in np.unique(refi[valid[:, lidx], lidx])})
    if len(used) > MAX_REF_SLOTS:
        raise ValueError(f"{len(used)} reference slots > {MAX_REF_SLOTS}")
    n_ref = max(int(refi.max()) + 1, 1)
    poc = np.full((2, n_ref), -(1 << 30), np.int64)
    slot_of = np.zeros((2, n_ref), np.int32)
    refs = []
    for s, (lidx, r) in enumerate(used):
        poc[lidx, r] = refp[r][lidx].poc
        slot_of[lidx, r] = s
        pic = refp[r][lidx].pic
        refs.append((_ref_tensor(pic.y),
                     _ref_tensor(pic.u) if chroma else None,
                     _ref_tensor(pic.v) if chroma else None))
    ri = np.maximum(refi, 0)
    pocs = np.stack([poc[0, ri[:, 0]], poc[1, ri[:, 1]]], 1)
    dup = (valid[:, 0] & valid[:, 1] & (pocs[:, 0] == pocs[:, 1])
           & (mvx_c[:, 0] == mvx_c[:, 1]) & (mvy_c[:, 0] == mvy_c[:, 1]))
    valid[:, 1] &= ~dup

    rows = []
    for lidx in range(2):
        sel = np.nonzero(valid[:, lidx])[0]
        if len(sel) == 0:
            continue
        gx16 = ((x[sel] << 2) + mvx_c[sel, lidx]) << 2
        gy16 = ((y[sel] << 2) + mvy_c[sel, lidx]) << 2
        slot = slot_of[lidx, refi[sel, lidx]]
        mx, my = mvx[sel, lidx] << 2, mvy[sel, lidx] << 2
        planes = [(0, 0, 15, PAD_L << 4)]
        if chroma:
            planes.append((1, 1, 31, PAD_C << 5))
        for plane, s, frac, org in planes:
            case = ((mx & frac) != 0) * 1 + ((my & frac) != 0) * 2
            rows.append(np.stack(
                [np.full(len(sel), plane), cuw[sel] >> s, cuh[sel] >> s,
                 case, slot, gx16 + org, gy16 + org,
                 (y[sel] >> s) + BORDER, (x[sel] >> s) + BORDER,
                 np.full(len(sel), lidx)], 1))
    table = (np.concatenate(rows) if rows
             else np.zeros((0, 10), np.int64))
    _check_mc_windows(table, refs)
    lists = tuple(int((table[:, MC_LIST] == i).sum()) for i in (0, 1))
    return table.astype(np.int32), lists, tuple(refs)


def _check_mc_windows(table, refs):
    """Every filter window, taps included, inside its reference plane."""
    for plane in (0, 1):
        t = table[table[:, MC_PLANE] == plane]
        if len(t) == 0:
            continue
        fb, half, ntap = (4, 3, 8) if plane == 0 else (5, 1, 4)
        shapes = {tuple(r[plane].shape) for r in refs}
        if len(shapes) != 1:
            raise ValueError(f"reference planes differ in shape: {shapes}")
        (H, W), = shapes
        for pos, size, bit in ((MC_GX, MC_W, 1), (MC_GY, MC_H, 2)):
            taps = (t[:, MC_CASE] & bit) != 0
            lo = (t[:, pos] >> fb) - np.where(taps, half, 0)
            hi = lo + t[:, size] + np.where(taps, ntap - 1, 0)
            if (lo < 0).any() or (hi > (W if bit == 1 else H)).any():
                raise ValueError("MC window outside its reference plane")


@dataclass
class PackedFrame:
    """Everything the device half of one frame needs: host arrays, and the
    reference planes that MC reads, which stay on the device."""
    payload: np.ndarray          # int32, see `layout`
    layout: dict                 # name -> (offset, shape)
    coefs: np.ndarray            # int16: coef_y then coef_u, coef_v, flat
    coef_shapes: tuple           # ((h, w) luma, (h, w) chroma or None)
    bd: int
    chroma: bool
    deblock_on: bool
    addb: bool                   # ADDB maps instead of strengths (K11)
    suco: bool                   # SUCO-order chroma ver edges (K10)
    alf: tuple | None            # (enables, log2_ctu, across) or None (K13)
    iqt: bool                    # Main per-stage-clipped transforms
    eipd: bool                   # icu is the EIPD scan table (K6/K7)
    main_taps: bool              # Main (ADMVP) MC taps
    level_off: np.ndarray | None  # EIPD level offsets [L + 1], host
    geom: tuple                  # (h, w, h_scu, w_scu)
    shp_y: tuple                 # bordered working plane shapes
    shp_c: tuple | None
    mc_lists: tuple              # MC table rows of list 0, of list 1
    refs: tuple                  # per slot: (y, u, v) reference tensors


@dataclass
class DeviceFrame:
    """A PackedFrame after its host->device copies (views into two
    device buffers)."""
    tus: torch.Tensor            # int32 [Nt, 7]
    icu: torch.Tensor            # int32 [Nc, 8], EIPD: [Nc, 13 or 16]
    mc: torch.Tensor             # int32 [Nm, 10], list 0 rows first
    dbst: torch.Tensor | None    # int32 [6, h_scu, w_scu]
    addb_l: torch.Tensor | None  # int32 [2, hs2, ws2, 4]
    addb_c: torch.Tensor | None  # int32 [2, hs2, ws2, 7]
    suco_off: torch.Tensor | None    # int32 [h_scu + 1]
    suco_edges: torch.Tensor | None  # int32 [E, 3]
    alf_l: torch.Tensor | None   # int32 [25, 13]
    alf_c: torch.Tensor | None   # int32 [7]
    alf_on: torch.Tensor | None  # int32 [n_ctu]
    coef_y: torch.Tensor         # int16 [h_pad, w_pad]
    coef_u: torch.Tensor | None
    coef_v: torch.Tensor | None
    packed: PackedFrame


def pack_frame(job, sps, refp) -> PackedFrame:
    """Build the payload of one frame (intra, P or B, Baseline or Main,
    with SUCO, ADDB and ALF as the JAX backend packs them).
    `refp[refi][list]` are the reference pictures (host/dpb.py)."""
    fs = job.fs
    bd = sps.bit_depth_luma_minus8 + 8
    cfi = sps.chroma_format_idc
    if cfi not in (0, 1):
        raise UnsupportedStream("torch backend: 4:2:0/4:0:0 only")
    chroma = cfi == 1
    deblock_on = bool(fs.sh.deblocking_filter_on)
    is_main = bool(getattr(sps, "is_main", False))
    addb = bool(deblock_on and getattr(job, "addb_luma", None) is not None)
    iqt = bool(is_main and sps.tool_iqt)
    eipd = bool(is_main and sps.tool_eipd)

    pk = Packer()
    pk.add("tus", pack_itdq(fs, bd, chroma, iqt, main=is_main))
    level_off = None
    if eipd:
        icu, level_off = pack_intra_main(fs, job, chroma)
    else:
        icu = pack_intra(fs, job)
    pk.add("icu", icu)
    mc, mc_lists, refs = pack_mc(fs, job, refp, chroma)
    pk.add("mc", mc)
    suco = False
    if addb:
        # ADDB takes precedence over the SUCO order (pipeline.py:525)
        luma_p, chroma_p = addb_maps(fs, job)
        pk.add("addb_l", luma_p)
        pk.add("addb_c", chroma_p)
    elif deblock_on:
        dbst = np.stack([job.db_ver_y, job.db_hor_y, job.db_ver_u,
                         job.db_hor_u, job.db_ver_v, job.db_hor_v])
        if dbst.shape[1:] != (fs.h_scu, fs.w_scu):
            raise ValueError(f"deblock strength maps {dbst.shape[1:]} != "
                             f"SCU grid {(fs.h_scu, fs.w_scu)}")
        pk.add("dbst", dbst)
        if chroma and is_main and getattr(sps, "sps_suco_flag", 0):
            sched = chroma_ver_edges(fs, job)
            if sched is not None:     # else the plain raster order (:301)
                suco = True
                pk.add("suco_off", sched[0])
                pk.add("suco_edges", sched[1])
    alf = None
    if job.alf_param is not None:
        coef_l, coef_c, ctu_on, alf = alf_params(fs, job)
        pk.add("alf_l", coef_l)
        pk.add("alf_c", coef_c)
        pk.add("alf_on", ctu_on)
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
        bd=bd, chroma=chroma, deblock_on=deblock_on, addb=addb, suco=suco,
        alf=alf, iqt=iqt, eipd=eipd,
        main_taps=bool(is_main and sps.tool_admvp), level_off=level_off,
        geom=(fs.h, fs.w, fs.h_scu, fs.w_scu), shp_y=shp_y, shp_c=shp_c,
        mc_lists=mc_lists, refs=refs)


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
    return DeviceFrame(tus=view("tus"), icu=view("icu"), mc=view("mc"),
                       dbst=view("dbst"), addb_l=view("addb_l"),
                       addb_c=view("addb_c"), suco_off=view("suco_off"),
                       suco_edges=view("suco_edges"), alf_l=view("alf_l"),
                       alf_c=view("alf_c"), alf_on=view("alf_on"),
                       coef_y=coef_y, coef_u=coef_u, coef_v=coef_v,
                       packed=pf)
