"""Host half of one frame: the per-frame syntax tensors as one flat payload.

JAX-free port of `_Packer`, `_pack_itdq`, `_pack_mc`, `_pack_intra`,
`_pack_intra_main` and `_chroma_ver_waves` (xevd_tpu/ops/pipeline.py:79-116,
580-927) and of the ADDB and ALF parts of `JaxPixelBackend.pack_frame`
(:505-517, 538-546) for Baseline and Main intra and inter frames.  What the JAX version does only to keep
jit signatures stable is gone: no pow2 bucket padding, no pad rows at
1<<20, no per-size or per-(size, case) buckets, no per-size-class
wavefront slots.  The TU table and the MC block table are one list each,
which the ITDQ kernel walks in a single launch and the MC kernel in one
launch per reference list, each in the order of a class order that the
pack builds beside it (`itdq_order`, `mc_order`); the EIPD scan table is
one list sorted by wavefront level, with the level offsets beside it in
the payload (the scan kernel walks the levels on the card); the SUCO
chroma edges are one list sorted by SCU row and rank, with row offsets
(no waves), and beside it the same edges by run, which the K10 kernel
walks (`suco_runs`).
`stack_frames` stacks the G frames of one time step of a GOP batch (K15)
into one such payload, with per-frame row offsets and the batched intra
scan's ticket order over the frames' CU rows (`icu_order`).

Per frame there is one int32 payload and one int16 coefficient buffer, so
two host->device copies.  The backend packs both into a slot of its
staging ring (ops/staging.py, the counterpart of the JAX backend's reused
payload buffers): every table is written straight into the slot's payload
(`Packer(buf)`), and the coefficient planes are copied once into its
coefficient buffer -- a copy that stays, since the native entropy engine
reuses its coefficient scratch two slices later (xevd_tpu/ops/
pipeline.py:483-488).  On the card the slot is pinned and `upload` copies
without blocking the host; on the CPU it clones.  Without a slot (the
tests, the kernel cases) both are fresh host arrays and the copies are
blocking ones."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..host import tables as T
from ..host.syntax import UnsupportedStream

from ..plane import DevicePlane
from .intra import intra_depths_host
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
MAX_REF_SLOTS = 32      # a frame's MC pointer table (csrc/mc.cu)
# SUCO chroma edge columns: x of the edge in chroma samples, strength in U
# and in V (xevd_tpu/ops/jax_deblock.py:134-136 without the row, which the
# row offsets give)
SE_COL, SE_ST_U, SE_ST_V = range(3)


class Packer:
    """Flat int32 payload assembler; `layout` maps name -> (offset, shape).
    The port of `_Packer` (xevd_tpu/ops/pipeline.py:79-113): with a
    backing buffer `buf` (int32, 1-D), `alloc` returns views into it and
    `finish` copies nothing; once the tables outgrow it (`overflow`),
    every later table is a fresh array and `finish` concatenates them
    all."""

    def __init__(self, buf: np.ndarray | None = None):
        self.buf = buf
        self.chunks = []
        self.layout = {}
        self.off = 0
        self.overflow = False

    def alloc(self, name: str, shape) -> np.ndarray:
        """The int32 array of table `name`, to be filled in place."""
        shape = tuple(int(d) for d in shape)
        size = int(np.prod(shape))
        if (self.buf is not None and not self.overflow
                and self.off + size <= self.buf.size):
            arr = self.buf[self.off:self.off + size].reshape(shape)
        else:
            self.overflow = True
            arr = np.empty(shape, np.int32)
        self.layout[name] = (self.off, shape)
        self.chunks.append(arr)
        self.off += size
        return arr

    def add(self, name: str, arr: np.ndarray):
        arr = np.asarray(arr)
        self.alloc(name, arr.shape)[...] = arr

    def finish(self):
        """(payload, layout): the head of `buf`, or with no buffer or
        after an overflow the tables concatenated (`overflow` says
        which)."""
        if self.buf is not None and not self.overflow:
            return self.buf[:self.off], dict(self.layout)
        if not self.chunks:
            return np.zeros(0, np.int32), dict(self.layout)
        return (np.concatenate([c.ravel() for c in self.chunks]),
                dict(self.layout))


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


ITDQ_THREADS = 256       # a CTA of the ITDQ kernel (csrc/itdq.cu)


@dataclass
class ItdqOrder:
    """The ITDQ kernel's launch over a TU table grouped by size class
    (csrc/itdq.cu): `order` int32 [N, 2] lists (TU row, frame g) class by
    class, each class's rows in table order; `classes` int32 [K, 4] gives
    each class present its first CTA, first order entry, TU count and shape
    (main << 16) | (log2 R << 12) | (log2 T << 8) | (log2 w << 4) | log2 h,
    T the threads a TU in a CTA, R the CTAs a TU; `n_cta` CTAs with `smem`
    bytes of dynamic shared memory each.  Host arrays from `itdq_order`,
    device views after an upload."""
    order: np.ndarray | torch.Tensor
    classes: np.ndarray | torch.Tensor
    n_cta: int
    smem: int


def itdq_order(tus: np.ndarray, iqt: bool, frame=None) -> ItdqOrder:
    """Group the TU rows by class (log2 w, log2 h, Main or Baseline: the
    frame's `iqt` or the TU's trs) with a counting sort (numpy's stable sort
    of uint8 keys is a radix sort), the table itself unchanged.  A class of
    n = w h samples runs T = clamp(n / 4, 16, 256) threads a TU, 256 / T
    TUs a CTA, and takes 6 n bytes of shared memory a TU; above 1,024
    samples a TU takes R = n / 1,024 CTAs (its rows split R ways) and
    2 n + 4 n / R bytes in each.  `frame`: each row's frame g in a GOP
    batch (zeros by default)."""
    t = np.asarray(tus)
    lw, lh = t[:, TU_LOG2W], t[:, TU_LOG2H]
    if len(t) and (min(lw.min(), lh.min()) < 1 or max(lw.max(),
                                                      lh.max()) > 6):
        raise ValueError("TU size outside 2..64")
    # class = main * 36 + (lw - 1) * 6 + lh - 1, in uint8 throughout
    cls = lw.astype(np.uint8) * np.uint8(6) + lh.astype(np.uint8)
    cls -= np.uint8(7)
    if iqt:
        cls += np.uint8(36)
    else:
        cls += (t[:, TU_TRS] != 0).astype(np.uint8) * np.uint8(36)
    perm = np.argsort(cls, kind="stable")
    counts = np.bincount(cls, minlength=72)
    present = np.nonzero(counts)[0]
    m, lw_c, lh_c = present // 36, present // 6 % 6 + 1, present % 6 + 1
    log2_n = lw_c + lh_c
    log2_r = np.maximum(log2_n - 10, 0)
    log2_t = np.clip(log2_n - 2 - log2_r, 4, 8)
    per_cta = ITDQ_THREADS >> log2_t
    n_tu = counts[present]
    ctas = -(-n_tu // per_cta) << log2_r
    classes = np.stack([np.cumsum(ctas) - ctas, np.cumsum(n_tu) - n_tu, n_tu,
                        (m << 16) | (log2_r << 12) | (log2_t << 8)
                        | (lw_c << 4) | lh_c], 1)
    order = np.zeros((len(t), 2), np.int32)
    order[:, 0] = perm
    if frame is not None:
        order[:, 1] = np.asarray(frame)[perm]
    return ItdqOrder(
        order=order,
        classes=classes.astype(np.int32).reshape(-1, 4),
        n_cta=int(ctas.sum()),
        smem=int((per_cta * ((2 << log2_n) + (4 << log2_n >> log2_r)))
                 .max()) if len(present) else 0)


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
    order of the cascade within the row (rows never interact).

    Vectorised: an SCU is coded when CU i is visited iff a CU before i
    covers it, so the map of the first CU covering each SCU (painted once,
    in reverse visit order) decides every CU's left and right candidate
    edges at once; the candidates' rows are expanded with np.repeat in
    visit order (CU, left before right, top to bottom), and a stable sort
    by row gives each row's edges in rank order."""
    h_scu, w_scu = fs.h_scu, fs.w_scu
    w, h = fs.w, fs.h
    h_scu_max = (h + 3) >> 2
    n = fs.num_cus()
    x0 = np.asarray(fs.cu_x[:n], np.int64)
    y0 = np.asarray(fs.cu_y[:n], np.int64)
    cuw = np.left_shift(1, np.asarray(fs.cu_log2w[:n], np.int64))
    cuh = np.left_shift(1, np.asarray(fs.cu_log2h[:n], np.int64))
    xs_, ys_, scuw, scuh = x0 >> 2, y0 >> 2, cuw >> 2, cuh >> 2
    first = np.full((h_scu, w_scu), n, np.int64)   # first CU covering an SCU
    for i, (a, b, c, d) in reversed(list(enumerate(zip(
            ys_.tolist(), xs_.tolist(), scuh.tolist(), scuw.tolist())))):
        first[a:a + c, b:b + d] = i
    idx = np.arange(n)
    chroma = np.asarray(fs.cu_tree[:n]) != 1            # do_chroma
    # (the column indices clamped where the condition beside them fails)
    left = chroma & (0 < x0) & (x0 < w)
    left &= first[ys_, np.maximum(xs_ - 1, 0)] < idx
    xr = xs_ + scuw
    right = chroma & (x0 + cuw < w) & (xr < w_scu)
    right &= first[ys_, np.minimum(xr, w_scu - 1)] < idx
    # the candidates in visit order: CU by CU, the left one first
    take = np.stack([left, right], 1).ravel()
    xp = np.stack([xs_, xr], 1).ravel()[take]
    y_lo = np.repeat(ys_, 2)[take]
    cnt = np.maximum(np.minimum(np.repeat(ys_ + scuh, 2)[take], h_scu_max)
                     - y_lo, 0)
    rows = np.repeat(y_lo - (np.cumsum(cnt) - cnt), cnt) + np.arange(
        int(cnt.sum()))
    cols = np.repeat(xp, cnt)
    su = np.asarray(job.db_ver_u)[rows, cols]
    sv = np.asarray(job.db_ver_v)[rows, cols]
    keep = (su != 0) | (sv != 0)
    if not keep.any():
        return None
    rows = rows[keep]
    order = np.argsort(rows, kind="stable")     # rank order within a row
    row_off = np.concatenate(
        [[0], np.cumsum(np.bincount(rows, minlength=h_scu))]).astype(np.int32)
    edges = np.stack([cols[keep] * 2, su[keep], sv[keep]],
                     1).astype(np.int32)[order]
    if (rows >= h_scu).any() or (edges[:, SE_COL] < 2).any() \
            or (edges[:, SE_COL] > 2 * w_scu - 2).any():
        # the filter reads 2 samples a side, without clamping
        raise ValueError("SUCO chroma edge outside the chroma area")
    return row_off, np.ascontiguousarray(edges)


@dataclass
class SucoRuns:
    """K10's launch over a SUCO edge table split into runs
    (csrc/deblock.cu `chroma_ver_runs_kernel`).  A run of a plane is a
    maximal set of edge columns of one SCU row, 2 chroma samples apart,
    that all have a strength in that plane; its edges (a repeated column
    as often as it is listed) filter in list order, and runs never touch
    each other's samples.  `row_runs` int32 [2 h_scu + 1]: the runs of
    SCU row r in plane p (0 U, 1 V) are row_runs[2 r + p] ..
    row_runs[2 r + p + 1], by first column; `run_off` int32 [R + 1]: run
    k's entries are entries[run_off[k]:run_off[k + 1]]; `entries` int32
    [N] = x | st << 16, x in chroma samples.  `row_runs_max` and
    `row_entries_max`: the most runs and entries of one SCU row (both
    planes), which size the kernel's shared memory.  Host arrays from
    `suco_runs`, device views after an upload."""
    row_runs: np.ndarray | torch.Tensor
    run_off: np.ndarray | torch.Tensor
    entries: np.ndarray | torch.Tensor
    row_runs_max: int
    row_entries_max: int


def suco_runs(row_off: np.ndarray, edges: np.ndarray) -> SucoRuns:
    """The run table of a SUCO edge table (row_off int32 [h_scu + 1],
    edges int32 [E, 3], `chroma_ver_edges`), vectorised: each edge with a
    strength in plane p marks its column in grid row 2 r + p (a column of
    padding between rows, so no run spans two), a run starts at each
    marked cell whose left neighbour is unmarked, and a stable sort by run
    keeps list order within a run.  ops/deblock.py `suco_runs_plain`
    states the same split plainly."""
    h_scu = len(row_off) - 1
    e = np.asarray(edges, np.int32).reshape(-1, 3)
    x = e[:, SE_COL]
    col = x >> 1
    if len(e) and ((x & 1).any() or col.min() < 1 or x.max() >= 1 << 16
                   or e[:, SE_ST_U:].max() >= 1 << 15):
        raise ValueError("SUCO edge table: odd, negative or oversized column "
                         "or strength")
    stride = int(col.max()) + 2 if len(e) else 2
    row = np.repeat(np.arange(h_scu, dtype=np.int32), np.diff(row_off))
    cell = row * (2 * stride) + col
    cells, ents = [], []
    for p in (0, 1):
        st = e[:, SE_ST_U + p]
        on = st > 0
        cells.append(cell[on] + p * stride)
        ents.append(x[on] | st[on] << 16)
    cells = np.concatenate(cells)
    grid = np.zeros(2 * h_scu * stride, bool)
    grid[cells] = True
    marked = np.flatnonzero(grid)
    head = np.ones(len(marked), bool)
    head[1:] = np.diff(marked) != 1
    run_of = np.empty(len(grid), np.int32)
    run_of[marked] = np.cumsum(head, dtype=np.int32) - 1
    ent_run = run_of[cells]
    row_runs = _offsets(np.bincount(marked[head] // stride,
                                    minlength=2 * h_scu))
    run_off = _offsets(np.bincount(ent_run, minlength=int(head.sum())))
    runs = row_runs[2::2] - row_runs[:-1:2]
    ents_row = run_off[row_runs[2::2]] - run_off[row_runs[:-1:2]]
    return SucoRuns(
        row_runs=row_runs, run_off=run_off,
        entries=np.concatenate(ents)[np.argsort(ent_run, kind="stable")],
        row_runs_max=int(runs.max()) if h_scu else 0,
        row_entries_max=int(ents_row.max()) if h_scu else 0)


def add_addb_maps(pk: Packer, fs, job):
    """Add the per-SCU ADDB parameter maps to `pk`, filled in place:
    "addb_l" int32 [2, hs2, ws2, 4] and "addb_c" [2, hs2, ws2, 7] ([0]
    vertical, [1] horizontal edges; luma (bs, alpha, beta, c1), chroma
    (bs, alpha, beta, c0 of U, alpha, beta, c0 of V)), padded to an even
    SCU count with bs = 0 so the covered area is a multiple of 8 px
    (xevd_tpu/ops/pipeline.py:505-517)."""
    h, w = fs.h_scu, fs.w_scu
    hs2, ws2 = (h + 1) & ~1, (w + 1) & ~1
    for name, src, k in (("addb_l", job.addb_luma, 4),
                         ("addb_c", job.addb_chroma, 7)):
        m = pk.alloc(name, (2, hs2, ws2, k))
        m[:, :h, :w] = src
        m[:, h:] = 0
        m[:, :h, w:] = 0


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


def ref_slots(fs, job):
    """The reference slots of a frame's MC table, in slot order: the
    (list, refi) pairs its inter CUs use."""
    idx = np.nonzero(fs.cu_pred_mode != T.MODE_INTRA)[0]
    if len(idx) == 0:
        return []
    refi = job.cu_refi[idx]
    valid = refi >= 0
    return sorted({(lidx, int(r)) for lidx in range(2)
                   for r in np.unique(refi[valid[:, lidx], lidx])})


def pack_mc(fs, job, refp, chroma, plane=None):
    """(table, lists, refs): the MC block table int32 [N, 10] (columns
    MC_*), the rows of list 0 first; lists = (rows of list 0, rows of list
    1); the reference planes, one (y, u, v) tuple per slot (u, v None for
    4:0:0): `plane(p)` of each picture plane p, by default its tensor on
    the device (a DevicePlane's).

    Port of `_pack_mc` (xevd_tpu/ops/pipeline.py:678-799): MV clip, the
    identical-motion skip, the (list, refi) -> slot map.  The filter case
    comes from the MV before clipping, the position from the clipped MV
    (ref: src_base/xevd_mc.c:435-557).  Raises ValueError when a block or
    its filter window, taps included, would leave its plane: the kernel
    reads without clamping."""
    plane = plane or _ref_tensor
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
    used = ref_slots(fs, job)
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
        refs.append((plane(pic.y), plane(pic.u) if chroma else None,
                     plane(pic.v) if chroma else None))
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


MC_THREADS = 256         # a CTA of the MC kernel (csrc/mc.cu)
# the MC kernel's threads an H100 holds at once: 3 CTAs an SM, 132 SMs
MC_CARD_THREADS = 3 * 132 * MC_THREADS


@dataclass
class McOrder:
    """The MC kernel's two launches (one a reference list) over a block
    table grouped by class (csrc/mc.cu): `order` int32 [N, 2] lists
    (table row, frame g), list 0's rows then list 1's, each list frame by
    frame, each frame class by class and each class's rows in table order;
    `classes` int32 [K, 4] gives each (list, frame, class) present its
    first CTA in its list's launch, first order entry, block count and
    shape (plane << 13) | (log2 Q << 11) | (log2 R << 8) | (log2 w << 5) |
    (log2 h << 2) | case, a thread taking a tile of Q columns by R rows of
    a block; `lists` = ((first class, classes, CTAs) of list 0, of list
    1).  Host arrays from `mc_order`, device views after an upload."""
    order: np.ndarray | torch.Tensor
    classes: np.ndarray | torch.Tensor
    lists: tuple


def mc_order(table: np.ndarray, lists: tuple, frame=None) -> McOrder:
    """Group each list's MC rows by frame and then by class (plane, log2 w,
    log2 h, filter case: at most 200 a list and frame) with a counting
    sort (numpy's stable sort of uint16 keys is a radix sort; above 127
    frames a batch, a stable sort of wider keys), the table itself
    unchanged.  Frame-major order keeps a GOP batch's CTAs in flight on
    one frame's planes at a time, so its scattered writes complete their
    sectors in L2.  A thread takes a tile of Q = min(w, 4) columns by R
    rows of one block; a class's block takes w h / (Q R) threads (at most
    256), and a CTA MC_THREADS / that many blocks.  R = min(h, 4) where a
    list's launch then fits the card at once (MC_CARD_THREADS: a launch of
    one partial wave takes as long as a thread's chain of window rows, 7
    or 3 more than R), else min(h, 8) (fewer rows loaded an output).
    `lists` = (rows of list 0, of list 1), list 0's first; `frame`: each
    row's frame g in a GOP batch (zeros by default)."""
    t = np.asarray(table)
    n0, n1 = lists
    if n0 + n1 != len(t):
        raise ValueError(f"MC lists {lists} != {len(t)} table rows")
    plane = t[:, MC_PLANE]
    w, h, case = t[:, MC_W], t[:, MC_H], t[:, MC_CASE]
    lw = np.log2(np.maximum(w, 1)).astype(np.int64)
    lh = np.log2(np.maximum(h, 1)).astype(np.int64)
    lmin = 2 - plane                               # luma 4..64, chroma 2..32
    if len(t) and (((plane != 0) & (plane != 1)).any() or (w != 1 << lw).any()
                   or (h != 1 << lh).any() or (lw < lmin).any()
                   or (lh < lmin).any() or (lw > lmin + 4).any()
                   or (lh > lmin + 4).any() or (case < 0).any()
                   or (case > 3).any()):
        raise ValueError("MC block outside the kernel's classes: luma 4..64, "
                         "chroma 2..32 a side, cases 0..3")
    g = (np.zeros(len(t), np.int64) if frame is None
         else np.asarray(frame, np.int64))
    n_g = int(g.max()) + 1 if len(t) else 1
    # class = plane * 100 + (log2 w - lmin) * 20 + (log2 h - lmin) * 4 +
    # case, under the 256s of its (list, frame) segment
    seg = g + n_g * (np.arange(len(t)) >= n0)
    key = (seg << 8) + plane * 100 + (lw - lmin) * 20 + (lh - lmin) * 4 + case
    if 2 * n_g <= 256:
        key = key.astype(np.uint16)
    perm = np.argsort(key, kind="stable")
    present, n_blk = np.unique(key, return_counts=True)
    present = present.astype(np.int64)
    cls = present % 256
    p_c, case_c = cls // 100, cls % 4
    lw_c = cls % 100 // 20 + 2 - p_c
    lh_c = cls % 20 // 4 + 2 - p_c
    lq = np.minimum(lw_c, 2)
    list_c = (present >> 8 >= n_g).astype(np.int64)

    def cta_counts(lr):
        return -(-n_blk // (MC_THREADS >> (lw_c - lq + lh_c - lr)))
    # R = 4 where a list's launch then fits the card at once, else R = 8
    lr = np.minimum(lh_c, 3)
    short = np.minimum(lh_c, 2)
    fits = np.bincount(list_c, cta_counts(short), minlength=2) * MC_THREADS
    lr = np.where(fits[list_c] <= MC_CARD_THREADS, short, lr)
    ctas = cta_counts(lr)
    classes = np.zeros((len(present), 4), np.int64)
    classes[:, 1] = np.cumsum(n_blk) - n_blk
    classes[:, 2] = n_blk
    classes[:, 3] = ((p_c << 13) | (lq << 11) | (lr << 8) | (lw_c << 5)
                     | (lh_c << 2) | case_c)
    launches = []
    for lidx in range(2):
        ks = np.nonzero(list_c == lidx)[0]
        c = ctas[ks]
        classes[ks, 0] = np.cumsum(c) - c
        launches.append((int(ks[0]) if len(ks) else 0, len(ks),
                         int(c.sum())))
    order = np.zeros((len(t), 2), np.int32)
    order[:, 0] = perm
    order[:, 1] = g[perm]
    return McOrder(order=order, classes=classes.astype(np.int32),
                   lists=tuple(launches))


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
    geom: tuple                  # (h, w, h_scu, w_scu)
    shp_y: tuple                 # bordered working plane shapes
    shp_c: tuple | None
    mc_lists: tuple              # MC table rows of list 0, of list 1
    refs: tuple                  # per slot: (y, u, v) reference tensors
    ref_pocs: tuple = ()         # per slot: the reference picture's POC
    tu_launch: tuple = (0, 0)    # ItdqOrder's (n_cta, smem)
    mc_launch: tuple = ((0, 0, 0), (0, 0, 0))   # McOrder's lists
    suco_launch: tuple = (0, 0)  # SucoRuns' (row_runs_max, row_entries_max)
    slot: object = None          # the staging slot (ops/staging.py
    #                              HostSlot) that payload and coefs view

    def copy(self) -> "PackedFrame":
        """This frame with its own host arrays, detached from its slot (a
        slot is rewritten when the ring comes round to it again): for
        whoever keeps a frame to replay its kernels later."""
        return dataclasses.replace(self, payload=self.payload.copy(),
                                   coefs=self.coefs.copy(), slot=None)


@dataclass
class DeviceFrame:
    """A PackedFrame after its host->device copies (views into two
    device buffers)."""
    tus: torch.Tensor            # int32 [Nt, 7]
    tu_order: ItdqOrder          # the TUs by size class (views)
    icu: torch.Tensor            # int32 [Nc, 8], EIPD: [Nc, 13 or 16]
    level_off: torch.Tensor | None   # EIPD: int32 [L + 1] level offsets
    mc: torch.Tensor             # int32 [Nm, 10], list 0 rows first
    mc_order: McOrder            # the MC rows by class (views)
    dbst: torch.Tensor | None    # int32 [6, h_scu, w_scu]
    addb_l: torch.Tensor | None  # int32 [2, hs2, ws2, 4]
    addb_c: torch.Tensor | None  # int32 [2, hs2, ws2, 7]
    suco_off: torch.Tensor | None    # int32 [h_scu + 1]
    suco_edges: torch.Tensor | None  # int32 [E, 3]
    suco_runs: SucoRuns | None       # the edges by run (views)
    alf_l: torch.Tensor | None   # int32 [25, 13]
    alf_c: torch.Tensor | None   # int32 [7]
    alf_on: torch.Tensor | None  # int32 [n_ctu]
    coef_y: torch.Tensor         # int16 [h_pad, w_pad]
    coef_u: torch.Tensor | None
    coef_v: torch.Tensor | None
    packed: PackedFrame


def coef_count(fs, chroma: bool) -> int:
    """The coefficients of a frame's planes (luma, then chroma)."""
    return fs.coef_y.size + (fs.coef_u.size + fs.coef_v.size if chroma
                             else 0)


def pack_frame(job, sps, refp, plane=None, slot=None) -> PackedFrame:
    """Build the payload of one frame (intra, P or B, Baseline or Main,
    with SUCO, ADDB and ALF as the JAX backend packs them).
    `refp[refi][list]` are the reference pictures (host/dpb.py); `plane`
    as in `pack_mc`.  `slot`: a staging slot (ops/staging.py `HostSlot`)
    to pack into -- every table written straight into its payload buffer
    (ADDB's and the Baseline strength maps filled in place), the
    coefficient planes copied into its coefficient buffer; without one,
    fresh host arrays.  The bytes are the same either way."""
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

    pk = Packer(None if slot is None else slot.payload_np)
    tus = pack_itdq(fs, bd, chroma, iqt, main=is_main)
    tu_order = itdq_order(tus, iqt)
    pk.add("tus", tus)
    pk.add("tu_order", tu_order.order)
    pk.add("tu_cls", tu_order.classes)
    if eipd:
        icu, level_off = pack_intra_main(fs, job, chroma)
        pk.add("icu", icu)
        pk.add("level_off", level_off)
    else:
        pk.add("icu", pack_intra(fs, job))
    mc, mc_lists, refs = pack_mc(fs, job, refp, chroma, plane)
    ref_pocs = tuple(refp[r][lidx].poc for lidx, r in ref_slots(fs, job))
    mc_ord = mc_order(mc, mc_lists)
    pk.add("mc", mc)
    pk.add("mc_order", mc_ord.order)
    pk.add("mc_cls", mc_ord.classes)
    suco, suco_launch = False, (0, 0)
    if addb:
        # ADDB takes precedence over the SUCO order (pipeline.py:525)
        add_addb_maps(pk, fs, job)
    elif deblock_on:
        maps = (job.db_ver_y, job.db_hor_y, job.db_ver_u, job.db_hor_u,
                job.db_ver_v, job.db_hor_v)
        shapes = {np.shape(m) for m in maps}
        if shapes != {(fs.h_scu, fs.w_scu)}:
            raise ValueError(f"deblock strength maps {shapes} != "
                             f"SCU grid {(fs.h_scu, fs.w_scu)}")
        dbst = pk.alloc("dbst", (6, fs.h_scu, fs.w_scu))
        for d, m in zip(dbst, maps):
            d[...] = m
        if chroma and is_main and getattr(sps, "sps_suco_flag", 0):
            sched = chroma_ver_edges(fs, job)
            if sched is not None:     # else the plain raster order (:301)
                suco = True
                runs = suco_runs(*sched)
                pk.add("suco_off", sched[0])
                pk.add("suco_edges", sched[1])
                pk.add("suco_rows", runs.row_runs)
                pk.add("suco_run_off", runs.run_off)
                pk.add("suco_entries", runs.entries)
                suco_launch = (runs.row_runs_max, runs.row_entries_max)
    alf = None
    if job.alf_param is not None:
        coef_l, coef_c, ctu_on, alf = alf_params(fs, job)
        pk.add("alf_l", coef_l)
        pk.add("alf_c", coef_c)
        pk.add("alf_on", ctu_on)
    payload, layout = pk.finish()
    if slot is not None and pk.overflow:
        payload = slot.keep_payload(payload)

    planes = [fs.coef_y] + ([fs.coef_u, fs.coef_v] if chroma else [])
    n = coef_count(fs, chroma)
    if slot is None:
        coefs = np.empty(n, np.int16)
    else:
        slot.reserve(coef_count=n)
        coefs = slot.coefs_np[:n]
    off = 0
    for p in planes:
        coefs[off:off + p.size] = np.asarray(p).reshape(-1)
        off += p.size
    shp_y = (BORDER + fs.h_pad + PAD_R, BORDER + fs.w_pad + PAD_R)
    shp_c = ((BORDER + (fs.h_pad >> 1) + PAD_R,
              BORDER + (fs.w_pad >> 1) + PAD_R) if chroma else None)
    return PackedFrame(
        payload=payload, layout=layout, coefs=coefs,
        coef_shapes=(fs.coef_y.shape,
                     fs.coef_u.shape if chroma else None),
        bd=bd, chroma=chroma, deblock_on=deblock_on, addb=addb, suco=suco,
        alf=alf, iqt=iqt, eipd=eipd,
        main_taps=bool(is_main and sps.tool_admvp),
        geom=(fs.h, fs.w, fs.h_scu, fs.w_scu), shp_y=shp_y, shp_c=shp_c,
        mc_lists=mc_lists, refs=refs, ref_pocs=ref_pocs,
        tu_launch=(tu_order.n_cta, tu_order.smem), mc_launch=mc_ord.lists,
        suco_launch=suco_launch, slot=slot)


def _copies(payload, coefs, slot, device, reader=None):
    """The payload and the coefficients on `device`: two host->device
    copies.  From a staging slot: on a CUDA device each copy is issued
    without blocking the host (the slot must be pinned: from pageable
    memory a non_blocking copy still blocks), on the current stream into
    buffers allocated on it, and the slot's event is recorded after them;
    `reader`, a stream other than the current one that will read the
    buffers, waits for that event and keeps the buffers from reuse until
    its work is done.  For the CPU a slot's arrays are cloned: a device
    tensor never aliases a slot that a later frame rewrites.  Without a
    slot, blocking copies of fresh arrays."""
    if slot is None:
        return (torch.from_numpy(payload).to(device),
                torch.from_numpy(coefs).to(device))
    srcs = slot.sources(payload.size, coefs.size)
    if device.type != "cuda":
        return tuple(s.clone() for s in srcs)
    if not all(s.is_pinned() for s in srcs):
        raise RuntimeError("upload: the staging slot is not pinned; a "
                           "non_blocking copy from pageable memory blocks "
                           "the host")
    dsts = tuple(torch.empty(s.shape, dtype=s.dtype, device=device)
                 for s in srcs)
    for d, s in zip(dsts, srcs):
        d.copy_(s, non_blocking=True)
    slot.event.record(torch.cuda.current_stream(device))
    if reader is not None:
        for d in dsts:
            d.record_stream(reader)
        reader.wait_event(slot.event)
    return dsts


def upload(pf: PackedFrame, device: torch.device) -> DeviceFrame:
    """Two host->device copies (`_copies`; from the frame's slot, if it
    has one, without blocking the host on a card); every table is a view
    into them."""
    payload, coefs = _copies(pf.payload, pf.coefs, pf.slot, device)

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
    return DeviceFrame(tus=view("tus"),
                       tu_order=ItdqOrder(view("tu_order"), view("tu_cls"),
                                          *pf.tu_launch),
                       icu=view("icu"),
                       level_off=view("level_off"), mc=view("mc"),
                       mc_order=McOrder(view("mc_order"), view("mc_cls"),
                                        pf.mc_launch),
                       dbst=view("dbst"), addb_l=view("addb_l"),
                       addb_c=view("addb_c"), suco_off=view("suco_off"),
                       suco_edges=view("suco_edges"),
                       suco_runs=SucoRuns(view("suco_rows"),
                                          view("suco_run_off"),
                                          view("suco_entries"),
                                          *pf.suco_launch)
                       if pf.suco else None, alf_l=view("alf_l"),
                       alf_c=view("alf_c"), alf_on=view("alf_on"),
                       coef_y=coef_y, coef_u=coef_u, coef_v=coef_v,
                       packed=pf)


@dataclass
class PackedBatch:
    """The G frames of one time step of a GOP batch (K15, the frames one
    `jax.vmap` step of xevd_tpu/parallel/gop.py decodes) as one payload:
    each table is the frames' tables one after another with row offsets
    [G + 1] (frame g's rows are off[g]:off[g + 1]); the MC table holds list
    0 of every frame, then list 1, with offsets [2, G + 1] from each
    list's first row."""
    payload: np.ndarray          # int32, see `layout`
    layout: dict                 # tus, tu_off, tu_order, tu_cls, icu,
    #                              icu_off, icu_order, mc, mc_off,
    #                              mc_order, mc_cls, dbst
    coefs: np.ndarray            # int16 [G, L]: each frame's coefficients
    coef_shapes: tuple
    G: int
    bd: int
    chroma: bool
    deblock_on: bool
    iqt: bool
    main_taps: bool
    geom: tuple                  # (h, w, h_scu, w_scu)
    shp_y: tuple
    shp_c: tuple | None
    mc_lists: tuple              # MC rows of list 0, of list 1 (all frames)
    tu_launch: tuple = (0, 0)    # ItdqOrder's (n_cta, smem)
    mc_launch: tuple = ((0, 0, 0), (0, 0, 0))   # McOrder's lists
    slot: object = None          # the staging slot (ops/staging.py)


@dataclass
class DeviceBatch:
    """A PackedBatch after its two host->device copies (views)."""
    tus: torch.Tensor            # int32 [Nt, 7]
    tu_off: torch.Tensor         # int32 [G + 1]
    tu_order: ItdqOrder          # the TUs by size class, with their g
    icu: torch.Tensor            # int32 [Nc, 8]
    icu_off: torch.Tensor        # int32 [G + 1]
    icu_order: torch.Tensor      # int32 [Nc]: the scan's tickets' rows
    mc: torch.Tensor             # int32 [Nm, 10], list 0 rows first
    mc_off: torch.Tensor         # int32 [2, G + 1]
    mc_order: McOrder            # the MC rows by class, with their g
    dbst: torch.Tensor | None    # int32 [G, 6, h_scu, w_scu]
    coef_y: torch.Tensor         # int16 [G, h_pad, w_pad]
    coef_u: torch.Tensor | None
    coef_v: torch.Tensor | None
    packed: PackedBatch


def _table(pf: PackedFrame, name: str, ncol: int) -> np.ndarray:
    if name not in pf.layout:
        return np.zeros((0, ncol), np.int32)
    off, shape = pf.layout[name]
    return pf.payload[off:off + int(np.prod(shape))].reshape(shape)


def _offsets(counts) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def icu_order(tables, h_scu: int, w_scu: int) -> np.ndarray:
    """The batched Baseline intra scan's ticket order (csrc/intra.cu) over
    the frames' CU tables `tables` stacked one after another: int32 [N],
    ticket -> stacked row, the rows by (depth in their frame's dependency
    DAG, frame, row) (ops/intra.py `intra_depths`, the kernel's wait rule,
    computed by its C pass `intra_depths_host`).
    A row's writers are shallower, so the order is a topological order of
    every frame's DAG (a row waits only on rows with lower tickets; a
    non-causal table raises), and the tickets in flight, about the
    persistent grid's CTAs, are the frames' next wavefronts side by side:
    the batch's scan costs about its longest frame's chain, as JAX's
    vmapped scan does."""
    depth = np.concatenate([intra_depths_host(t, h_scu, w_scu)
                            for t in tables] + [np.zeros(0, np.int64)])
    return np.argsort(depth, kind="stable").astype(np.int32)


def stack_frames(frames, slots) -> PackedBatch:
    """Stack the PackedFrames of one time step of a GOP batch.  slots[g]
    maps frame g's reference slots to slots of the batch's DPB ring
    (ops/mc.py `DpbRing`: slot (d - 1) * G_dev + g is the picture d steps
    back of the device's GOP g); each MC row's slot column is rewritten
    through it.

    The frames must agree in size, bit depth, chroma format and the frame
    flags that pick kernel variants (Main transforms and taps, deblocking)
    -- JAX's step holds its statics equal (gop.py:138-141) -- and have
    none of the Main stages the batch has no kernels for (EIPD scan, SUCO
    order, ADDB, ALF); else UnsupportedStream."""
    def key(f):
        return (f.geom, f.bd, f.chroma, f.deblock_on, f.iqt, f.main_taps,
                f.shp_y, f.shp_c, f.coef_shapes)
    f0 = frames[0]
    for f in frames:
        if f.eipd or f.suco or f.addb or f.alf is not None:
            raise UnsupportedStream("torch GOP batch: no batched EIPD scan, "
                                    "SUCO-order deblock, ADDB or ALF")
        if key(f) != key(f0):
            raise UnsupportedStream("torch GOP batch: the frames of one step "
                                    "differ in size, bit depth, chroma "
                                    "format or frame flags")
    tus = [_table(f, "tus", TU_COLS) for f in frames]
    icu = [_table(f, "icu", 8) for f in frames]
    mcs = []
    for f, sl in zip(frames, slots):
        m = _table(f, "mc", 10).copy()
        if len(m):
            m[:, MC_SLOT] = np.asarray(sl, np.int32)[m[:, MC_SLOT]]
        mcs.append(m)
    n0 = [f.mc_lists[0] for f in frames]
    pk = Packer()
    tu_order = itdq_order(np.concatenate(tus), f0.iqt, np.repeat(
        np.arange(len(tus)), [len(t) for t in tus]))
    pk.add("tus", np.concatenate(tus))
    pk.add("tu_off", _offsets([len(t) for t in tus]))
    pk.add("tu_order", tu_order.order)
    pk.add("tu_cls", tu_order.classes)
    pk.add("icu", np.concatenate(icu))
    pk.add("icu_off", _offsets([len(t) for t in icu]))
    pk.add("icu_order", icu_order(icu, *f0.geom[2:]))
    n1 = [len(m) - n for m, n in zip(mcs, n0)]
    mc = np.concatenate([m[:n] for m, n in zip(mcs, n0)]
                        + [m[n:] for m, n in zip(mcs, n0)])
    g = np.arange(len(frames))
    mc_ord = mc_order(mc, (sum(n0), sum(n1)), np.concatenate(
        [np.repeat(g, n0), np.repeat(g, n1)]))
    pk.add("mc", mc)
    pk.add("mc_off", np.stack([_offsets(n0), _offsets(n1)]))
    pk.add("mc_order", mc_ord.order)
    pk.add("mc_cls", mc_ord.classes)
    if f0.deblock_on:
        pk.add("dbst", np.stack([_table(f, "dbst", 0) for f in frames]))
    payload, layout = pk.finish()
    return PackedBatch(
        payload=payload, layout=layout,
        coefs=np.stack([f.coefs for f in frames]),
        coef_shapes=f0.coef_shapes, G=len(frames), bd=f0.bd,
        chroma=f0.chroma, deblock_on=f0.deblock_on, iqt=f0.iqt,
        main_taps=f0.main_taps, geom=f0.geom, shp_y=f0.shp_y,
        shp_c=f0.shp_c,
        mc_lists=(sum(n0), sum(n1)),
        tu_launch=(tu_order.n_cta, tu_order.smem), mc_launch=mc_ord.lists)


def stage_batch(pb: PackedBatch, slot) -> PackedBatch:
    """`pb` with its payload and coefficients copied into a staging slot
    (ops/staging.py `HostSlot`, grown if need be; pinned on a card), from
    which `upload_batch` copies without blocking the host: the host's part
    of a GOP step's upload."""
    slot.reserve(pb.payload.size, pb.coefs.size)
    for name, src in (("payload", pb.payload), ("coefs", pb.coefs)):
        getattr(slot, name)[:src.size].copy_(torch.from_numpy(src).view(-1))
    return dataclasses.replace(
        pb, payload=slot.payload_np[:pb.payload.size],
        coefs=slot.coefs_np[:pb.coefs.size].reshape(pb.coefs.shape),
        slot=slot)


def upload_batch(pb: PackedBatch, device: torch.device,
                 reader=None) -> DeviceBatch:
    """Two host->device copies (`_copies`: from the batch's slot, if it
    has one, without blocking the host on a card; `reader`, the stream
    the kernels will read the batch on when the copies are issued on
    another); every table and plane is a view into them."""
    payload, coefs = _copies(pb.payload, pb.coefs, pb.slot, device, reader)
    coefs = coefs.view(pb.coefs.shape)

    def view(name):
        if name not in pb.layout:
            return None
        off, shape = pb.layout[name]
        return payload[off:off + int(np.prod(shape))].view(shape)

    G = pb.G
    (hy, wy), shc = pb.coef_shapes
    coef_y = coefs[:, :hy * wy].view(G, hy, wy)
    coef_u = coef_v = None
    if pb.chroma:
        hc, wc = shc
        n = hc * wc
        coef_u = coefs[:, hy * wy:hy * wy + n].view(G, hc, wc)
        coef_v = coefs[:, hy * wy + n:hy * wy + 2 * n].view(G, hc, wc)
    return DeviceBatch(tus=view("tus"), tu_off=view("tu_off"),
                       tu_order=ItdqOrder(view("tu_order"), view("tu_cls"),
                                          *pb.tu_launch),
                       icu=view("icu"), icu_off=view("icu_off"),
                       icu_order=view("icu_order"),
                       mc=view("mc"), mc_off=view("mc_off"),
                       mc_order=McOrder(view("mc_order"), view("mc_cls"),
                                        pb.mc_launch),
                       dbst=view("dbst"), coef_y=coef_y, coef_u=coef_u,
                       coef_v=coef_v, packed=pb)
