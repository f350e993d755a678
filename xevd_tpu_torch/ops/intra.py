"""Baseline intra reconstruction (the port of K5 `intra_scan`,
xevd_tpu/ops/jax_intra.py:113).

`intra_scan` updates the bordered picture planes in place: the CUDA kernel
(csrc/intra.cu, a persistent scan that follows each CU's dependencies,
one launch per frame or per GOP batch step) for CUDA planes,
`intra_scan_ref` (a Python loop over CUs in decode order) for CPU planes.
With CUDA planes every operand, the CU table included, must be on the
card.  With `icu_off` it scans the G frames of one time step of a GOP
batch (K15) in the same launch, its rows handed out in the ticket order
the pack ships beside the table (ops/pack.py `icu_order`: the rows of
every frame by their depth in its dependency DAG, `intra_depths`, so the
frames' chains run side by side, as in JAX's vmapped scan);
`intra_scan_ticket_ref` walks that order on the CPU, and
`intra_scan_batch_ref` (frame after frame, JAX's semantics) is what both
must equal.

`intra_deps_ref` is the kernel's dependency rule written in torch: a CU
waits for the CUs that wrote the 4x4 cells its masks name.  It equals
decode order only for a causal table, where every such cell was written
by an earlier CU or before the scan; the rule refuses any other."""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from ..host import tables as T

from .. import native_build as NB
from ..kernels import build as K
from .tables import BORDER


def _cu_plane_ref(rec, res, x, y, log2, ipm, up_mask, left_mask, corner_f,
                  unit, bd):
    """One CU on one plane (ref: xevd_tpu/ops/jax_intra.py:70-109)."""
    dev = rec.device
    cuw = 1 << log2
    n2 = 2 * cuw
    mid = 1 << (bd - 1)
    by, bx = BORDER + y, BORDER + x
    units = torch.arange(n2, device=dev) // unit
    up_ok = ((up_mask & 0xFFFFFFFF) >> units) & 1 == 1
    left_ok = ((left_mask & 0xFFFFFFFF) >> units) & 1 == 1
    up = torch.where(up_ok, rec[by - 1, bx:bx + n2].to(torch.int32), mid)
    left = torch.where(left_ok, rec[by:by + n2, bx - 1].to(torch.int32), mid)
    ii = torch.arange(cuw, device=dev)[:, None]
    jj = torch.arange(cuw, device=dev)[None, :]
    if ipm == T.IPD_VER_B:
        pred = up[:cuw][None, :].expand(cuw, cuw)
    elif ipm == T.IPD_HOR_B:
        pred = left[:cuw][:, None].expand(cuw, cuw)
    elif ipm == T.IPD_DC_B:
        dc = (left[:cuw].sum() + up[:cuw].sum() + cuw) >> (log2 + 1)
        pred = dc.expand(cuw, cuw)
    elif ipm == T.IPD_UL_B:
        corner = (rec[by - 1, bx - 1].to(torch.int32) if corner_f == 1
                  else torch.tensor(mid, dtype=torch.int32, device=dev))
        d = ii - jj
        pred = torch.where(d > 0, left[(d - 1).clamp(0, n2 - 1)],
                           torch.where(d == 0, corner,
                                       up[(-d - 1).clamp(0, n2 - 1)]))
    else:
        k = ii + jj + 1
        pred = (up[k] + left[k]) >> 1
    t = (pred + res[by:by + cuw, bx:bx + cuw].to(torch.int32)).to(torch.int16)
    rec[by:by + cuw, bx:bx + cuw] = t.clamp(0, (1 << bd) - 1)


def intra_cu_ref(recs, resids, row, bd, chroma):
    """One CU row (x, y, log2, ipm, up_mask, left_mask, corner, valid) of
    the scan, in place on `recs`: luma, then u and v."""
    x, y, log2, ipm, upm, lem, cor, valid = (int(v) for v in row)
    if valid != 1:
        return
    _cu_plane_ref(recs[0], resids[0], x, y, log2, ipm, upm, lem, cor, 4, bd)
    if chroma:
        for rec, res in ((recs[1], resids[1]), (recs[2], resids[2])):
            _cu_plane_ref(rec, res, x >> 1, y >> 1, log2 - 1, ipm, upm, lem,
                          cor, 2, bd)


def intra_scan_ref(recs, resids, icu, bd, chroma):
    """Plain version of `intra_scan` (in place on `recs`): every CU in
    decode order."""
    for row in icu.cpu().tolist():
        intra_cu_ref(recs, resids, row, bd, chroma)
    return recs


def intra_scan_batch_ref(recs, resids, icu, icu_off, bd, chroma):
    """Plain version of the batched `intra_scan`: frame g (planes [g], rows
    icu[icu_off[g]:icu_off[g + 1]]) through `intra_scan_ref`."""
    off = icu_off.cpu().tolist()
    for g in range(len(off) - 1):
        intra_scan_ref([None if r is None else r[g] for r in recs],
                       [None if r is None else r[g] for r in resids],
                       icu[off[g]:off[g + 1]], bd, chroma)
    return recs


def intra_scan_ticket_ref(recs, resids, icu, icu_off, order, bd, chroma):
    """Plain version of the batched CUDA scan's walk: the stacked table's
    rows one by one in ticket order (`order`, int32 [N]: ticket -> row,
    ops/pack.py `icu_order`), each on its frame's planes.  Equals
    `intra_scan_batch_ref` whenever the order is a topological order of
    every frame's dependency DAG (`intra_deps_ref`)."""
    off = np.asarray(icu_off.cpu())
    rows = icu.cpu().tolist()
    for n in order.cpu().tolist():
        # the last g with off[g] <= n, as csrc/batch.cuh `batch_of`
        g = int(np.searchsorted(off, n, side="right")) - 1
        intra_cu_ref([None if r is None else r[g] for r in recs],
                     [None if r is None else r[g] for r in resids],
                     rows[n], bd, chroma)
    return recs


def intra_deps_ref(icu, h_scu, w_scu) -> torch.Tensor:
    """The rows each CU row of one frame waits for in the CUDA scan: int64
    [N, 65], the writer of each cell its up mask (units 0..31), left
    mask (0..31) and corner flag name, -1 where the bit is clear or no row
    writes the cell (MC and recon wrote it before the scan; an invalid row
    writes nothing and waits on nothing).  The cells are the 4x4 cells of
    an h_scu x w_scu grid; luma's 4-px and 4:2:0 chroma's 2-px units are
    the same cells.  Raises ValueError where the CUDA scan would not equal
    decode order: a cell a row's masks name written by that row or a later
    one (a non-causal table), CUs that overlap or leave the grid."""
    t = torch.as_tensor(icu).to(torch.int64).cpu()
    n = t.shape[0]
    valid = t[:, 7] == 1
    xs, ys = t[:, 0] >> 2, t[:, 1] >> 2
    sw = 1 << (t[:, 2] - 2).clamp(min=0)
    rows = torch.nonzero(valid).flatten()
    cells = sw[rows] ** 2
    owner = torch.repeat_interleave(rows, cells)
    k = torch.arange(owner.numel()) - torch.repeat_interleave(
        torch.cumsum(cells, 0) - cells, cells)
    cy = ys[owner] + k // sw[owner]
    cx = xs[owner] + k % sw[owner]
    if ((cy < 0) | (cy >= h_scu) | (cx < 0) | (cx >= w_scu)).any():
        raise ValueError("intra CU outside the cell grid")
    flat = cy * w_scu + cx
    if flat.unique().numel() != flat.numel():
        raise ValueError("intra CUs overlap")
    wmap = torch.full((h_scu * w_scu,), -1, dtype=torch.int64)
    wmap[flat] = owner

    u = torch.arange(32)
    nu = (2 * sw)[:, None]
    up_on = ((t[:, 4:5] & 0xFFFFFFFF) >> u) & 1 == 1
    left_on = ((t[:, 5:6] & 0xFFFFFFFF) >> u) & 1 == 1
    cy = torch.cat([(ys - 1)[:, None].expand(n, 32), ys[:, None] + u,
                    (ys - 1)[:, None]], 1)
    cx = torch.cat([xs[:, None] + u, (xs - 1)[:, None].expand(n, 32),
                    (xs - 1)[:, None]], 1)
    on = torch.cat([up_on & (u < nu), left_on & (u < nu),
                    (t[:, 6:7] == 1)], 1) & valid[:, None]
    on &= (cy >= 0) & (cy < h_scu) & (cx >= 0) & (cx < w_scu)
    deps = torch.where(on, wmap[(cy * w_scu + cx).clamp(0, h_scu * w_scu - 1)],
                       -1)
    bad = deps >= torch.arange(n)[:, None]
    if bad.any():
        r = int(torch.nonzero(bad.any(1))[0, 0])
        raise ValueError(f"non-causal CU table: row {r} names a cell that "
                         f"row {int(deps[r].max())} writes")
    return deps


def intra_depths(icu, h_scu, w_scu) -> np.ndarray:
    """Each CU row's depth in its frame's dependency DAG under
    `intra_deps_ref`: int64 [N], 1 + the greatest depth of the rows it
    waits for (1 for a row that waits for none), 0 for an invalid row.
    Raises where `intra_deps_ref` does."""
    t = torch.as_tensor(icu).cpu()
    deps = intra_deps_ref(t, h_scu, w_scu).numpy()
    n = len(deps)
    # each row's distinct writers, as one flat list with row offsets
    s = np.sort(deps, axis=1)
    keep = s >= 0
    keep[:, 1:] &= s[:, 1:] != s[:, :-1]
    ends = np.cumsum(keep.sum(1)).tolist()
    writers = s[keep].tolist()
    valid = (t[:, 7] == 1).tolist()
    depth = [0] * n
    lo = 0
    for r in range(n):          # writers precede their readers
        hi = ends[r]
        if valid[r]:
            d = 0
            for w in writers[lo:hi]:
                if depth[w] > d:
                    d = depth[w]
            depth[r] = d + 1
        lo = hi
    return np.array(depth, np.int64)


_DEPTHS_SRC = Path(__file__).resolve().parent.parent / "native"
_DEPTHS_LIB = None


def _depths_lib():
    """xevd_tpu_torch/native/intra_depths.c, built for this host at first
    use (native_build.py: keyed on the sources, the command and the CPU);
    a failed build raises."""
    global _DEPTHS_LIB
    if _DEPTHS_LIB is None:
        so = NB.library_path(_DEPTHS_SRC, lib_name="libxevd_intra_depths.so")
        if not so.exists():
            NB.build_library([*NB.COMMAND, "-o", str(so),
                              str(_DEPTHS_SRC / "intra_depths.c")])
        lib = ctypes.CDLL(str(so))
        lib.xevd_intra_depths.argtypes = (ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_void_p)
        lib.xevd_intra_depths.restype = ctypes.c_int
        _DEPTHS_LIB = lib
    return _DEPTHS_LIB


def intra_depths_host(icu, h_scu, w_scu) -> np.ndarray:
    """`intra_depths` by one C pass over the table (native/intra_depths.c):
    int64 [N], equal to it, and raising where it raises."""
    t = np.ascontiguousarray(np.asarray(icu), np.int32).reshape(-1, 8)
    n = len(t)
    owner = np.empty(max(h_scu * w_scu, 1), np.int32)
    depth = np.empty(max(n, 1), np.int32)
    err = _depths_lib().xevd_intra_depths(
        t.ctypes.data, n, h_scu, w_scu, owner.ctypes.data, depth.ctypes.data)
    if err < 0:
        raise ValueError("intra CU outside the cell grid")
    if err > 2 * n:
        raise ValueError("intra CUs overlap")
    if err > 0:
        raise ValueError(f"non-causal CU table: row {err - n - 1} names a "
                         "cell that it or a later row writes")
    return depth[:n].astype(np.int64)


def intra_dag_depth(icu, h_scu, w_scu, icu_off=None) -> int:
    """The longest chain of dependent CU rows under `intra_deps_ref` (the
    steps the CUDA scan takes one after another); with `icu_off`, the
    longest over the G frames of a batch."""
    t = torch.as_tensor(icu).cpu()
    off = ([0, t.shape[0]] if icu_off is None
           else torch.as_tensor(icu_off).cpu().tolist())
    return max([int(intra_depths(t[lo:hi], h_scu, w_scu).max())
                for lo, hi in zip(off[:-1], off[1:]) if hi > lo] + [0])


def intra_scan(recs, resids, icu, bd, chroma, icu_off=None, order=None):
    """recs / resids: (y, u, v) bordered int16 planes (u/v unused when not
    `chroma`); icu: int32 [N, 8] CU table in decode order (ops/pack.py).
    Reconstructs every valid CU in place on `recs` and returns them.  A GOP
    batch of G frames: planes [G, H, W], `icu_off` int32 [G + 1], frame
    g's CUs at rows icu_off[g]:icu_off[g + 1], and `order` int32 [N], the
    rows in ticket order (ops/pack.py `icu_order`), without which a
    batched call raises; on the CPU it walks the order
    (`intra_scan_ticket_ref`)."""
    rec_y, rec_u, rec_v = recs
    res_y, res_u, res_v = resids
    batched = icu_off is not None
    if batched and order is None:
        raise ValueError("intra_scan: a batched call needs the ticket order "
                         "(ops/pack.py icu_order)")
    if rec_y.device.type == "cpu":
        if batched:
            return intra_scan_ticket_ref(recs, resids, icu, icu_off, order,
                                         bd, chroma)
        return intra_scan_ref(recs, resids, icu, bd, chroma)
    K.require(icu, torch.int32, 2, contiguous=True)
    if batched:
        K.require(icu_off, torch.int32, 1, contiguous=True)
    if order is not None:
        K.require(order, torch.int32, 1, contiguous=True)
        if order.shape[0] != icu.shape[0]:
            raise ValueError(f"intra_scan: {order.shape[0]} tickets for "
                             f"{icu.shape[0]} CU rows")
    nd = 3 if batched else 2
    G = icu_off.shape[0] - 1 if batched else 1
    planes = [(rec_y, res_y)] + ([(rec_u, res_u), (rec_v, res_v)]
                                 if chroma else [])
    for rec, res in planes:
        K.require(rec, torch.int16, nd, contiguous=True)
        K.require(res, torch.int16, nd, contiguous=True)
        if batched and rec.shape[0] != G:
            raise ValueError(f"intra_scan: {rec.shape[0]} planes for {G} "
                             "frames")
        if rec.shape != res.shape:
            raise ValueError("intra_scan: picture and residual planes differ "
                             f"in shape: {rec.shape} vs {res.shape}")
    if chroma and rec_u.shape != rec_v.shape:
        raise ValueError("intra_scan: u and v planes differ in shape")
    if icu.shape[1] != 8:
        raise ValueError(f"CU table wants 8 columns, got {tuple(icu.shape)}")
    n = icu.shape[0]
    if n == 0:
        return recs
    # the writer map's 4x4 cells: the bordered plane below and right of
    # the border, every cell a CU inside the plane can write
    hs, ws = (rec_y.shape[-2] - BORDER) >> 2, (rec_y.shape[-1] - BORDER) >> 2
    # the ticket counter, the rows' done flags, the frames' writer maps
    scratch = torch.zeros(1 + n + G * hs * ws, dtype=torch.int32,
                          device=icu.device)
    lib = K.lib()
    K.count("intra_scan")
    err = lib.xevd_intra_scan(
        rec_y.data_ptr(), rec_u.data_ptr() if chroma else None,
        rec_v.data_ptr() if chroma else None, res_y.data_ptr(),
        res_u.data_ptr() if chroma else None,
        res_v.data_ptr() if chroma else None,
        rec_y.stride(-2), rec_u.stride(-2) if chroma else 0,
        icu.data_ptr(), n, bd, int(chroma),
        icu_off.data_ptr() if batched else None,
        order.data_ptr() if order is not None else None, G,
        rec_y.stride(0) if batched else 0,
        rec_u.stride(0) if batched and chroma else 0,
        scratch.data_ptr(), hs, ws, K.stream_ptr(icu.device))
    K.check(err, "xevd_intra_scan")
    return recs
