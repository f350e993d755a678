"""Baseline deblocking (the port of K8 `luma_ver_pass` / `luma_hor_pass`,
K9 `chroma_ver_pass` / `chroma_hor_pass`, K10 `chroma_ver_ordered`,
xevd_tpu/ops/jax_deblock.py:59-188, and of K12 `_deblock_finish`,
xevd_tpu/ops/pipeline.py:285, which sequences them).

Every pass filters an SCU-cropped area in place (a strided view into the
bordered picture plane).  `st` is the per-SCU strength map
int32 [h_scu, w_scu] (0 = no edge).  CUDA tensors launch the kernels of
csrc/deblock.cu -- both luma passes as one kernel (`deblock_luma`) --
CPU tensors take the `*_ref` plain versions.  Luma and the chroma passes
also filter the areas [G, H, W] of a GOP batch (K15) with strengths [G,
...], in one launch each (plain: frame by frame)."""
from __future__ import annotations

import torch

from ..kernels import build as K


def _div_trunc(a, d_log2):
    """C truncating division by 2^d_log2 (torch's // floors)."""
    q = a.abs() >> d_log2
    return torch.where(a < 0, -q, q)


def _edge_delta(A, B, C, D, st):
    d = _div_trunc(A - (B << 2) + (C << 2) - D, 3)
    abs_d = d.abs()
    t16 = ((abs_d - st) * 2).clamp(min=0)
    clip = (abs_d - t16).clamp(min=0)
    return torch.where(d < 0, -clip, clip), clip


def _luma_filter(A, B, C, D, st, maxv):
    """(ref: xevd_tpu/ops/jax_deblock.py:29-43); st <= 0 passes through."""
    d1, clip = _edge_delta(A, B, C, D, st)
    clip2 = clip >> 1
    d2 = torch.maximum(torch.minimum(_div_trunc(A - D, 2), clip2), -clip2)
    on = st > 0
    return (torch.where(on, (A - d2).clamp(0, maxv), A),
            torch.where(on, (B + d1).clamp(0, maxv), B),
            torch.where(on, (C - d1).clamp(0, maxv), C),
            torch.where(on, (D + d2).clamp(0, maxv), D))


def _chroma_filter(A, B, C, D, st, maxv):
    """(ref: xevd_tpu/ops/jax_deblock.py:46-56); only B and C change."""
    d1, _ = _edge_delta(A, B, C, D, st)
    on = st > 0
    return (torch.where(on, (B + d1).clamp(0, maxv), B),
            torch.where(on, (C - d1).clamp(0, maxv), C))


def luma_ver_ref(area, st, bd):
    H, W = area.shape
    p4 = area.to(torch.int32).reshape(H, W // 4, 4)
    s = st.repeat_interleave(4, dim=0)[:, 1:]
    out = _luma_filter(p4[:, :-1, 2], p4[:, :-1, 3], p4[:, 1:, 0],
                       p4[:, 1:, 1], s, (1 << bd) - 1)
    p4[:, :-1, 2], p4[:, :-1, 3], p4[:, 1:, 0], p4[:, 1:, 1] = out
    area.copy_(p4.reshape(H, W))


def luma_hor_ref(area, st, bd):
    H, W = area.shape
    p4 = area.to(torch.int32).reshape(H // 4, 4, W)
    s = st.repeat_interleave(4, dim=1)[1:, :]
    out = _luma_filter(p4[:-1, 2, :], p4[:-1, 3, :], p4[1:, 0, :],
                       p4[1:, 1, :], s, (1 << bd) - 1)
    p4[:-1, 2, :], p4[:-1, 3, :], p4[1:, 0, :], p4[1:, 1, :] = out
    area.copy_(p4.reshape(H, W))


def _block_strengths(st_ver, st_hor, hs, ws, device):
    """Per shifted 4x4 block (f, e), f <= hs, e <= ws: the strength of the
    vertical edge on each of its four rows and of the horizontal edge on
    each of its four columns, int32 [hs + 1, ws + 1, 4] each (0 where the
    block has no such edge: the area's sides, or a map that is None)."""
    rows = torch.zeros(hs + 1, ws + 1, 4, dtype=torch.int32, device=device)
    cols = torch.zeros_like(rows)
    if st_ver is not None:        # rows 0, 1: SCU row f - 1; 2, 3: row f
        rows[1:, 1:ws, :2] = st_ver[:, 1:, None]
        rows[:hs, 1:ws, 2:] = st_ver[:, 1:, None]
    if st_hor is not None:        # columns 0, 1: SCU column e - 1; 2, 3: e
        cols[1:hs, 1:, :2] = st_hor[1:, :, None]
        cols[1:hs, :ws, 2:] = st_hor[1:, :, None]
    return rows, cols


def _filter_blocks(b, srow, scol, maxv):
    """In place on blocks b int32 [..., 4, 4]: the vertical edge of each
    row (strengths srow [..., 4]), then the horizontal edge of each column
    (scol [..., 4])."""
    b[..., 0], b[..., 1], b[..., 2], b[..., 3] = _luma_filter(
        b[..., 0], b[..., 1], b[..., 2], b[..., 3], srow, maxv)
    b[..., 0, :], b[..., 1, :], b[..., 2, :], b[..., 3, :] = _luma_filter(
        b[..., 0, :], b[..., 1, :], b[..., 2, :], b[..., 3, :], scol, maxv)


def luma_blocks_ref(area, st_ver, st_hor, bd, rng=None):
    """K8 in the order of its kernel (csrc/deblock.cu `luma_kernel`): each
    shifted 4x4 block (f, e), rows 4f - 2 .. 4f + 1 by columns 4e - 2 ..
    4e + 1 clipped to the area, filtered vertical edge, then horizontal
    edge; the blocks in raster order, eight block rows a step (blocks
    share no sample, so a step takes them at once), or one at a time in a
    random order drawn from `rng` (a numpy Generator).  Equal to
    `luma_ver_ref` then `luma_hor_ref` for every order: the statement that
    the shifted blocks are independent and closed under "ver, then hor".
    Either map may be None (no edge of that direction); areas [G, H, W]
    with maps [G, ...] frame by frame."""
    if area.dim() == 3:
        for g in range(area.shape[0]):
            luma_blocks_ref(area[g], None if st_ver is None else st_ver[g],
                            None if st_hor is None else st_hor[g], bd, rng)
        return area
    H, W = area.shape
    hs, ws = H // 4, W // 4
    p = torch.zeros(H + 4, W + 4, dtype=torch.int32, device=area.device)
    p[2:H + 2, 2:W + 2] = area
    blocks = p.view(hs + 1, 4, ws + 1, 4).permute(0, 2, 1, 3)
    srow, scol = _block_strengths(st_ver, st_hor, hs, ws, area.device)
    maxv = (1 << bd) - 1
    if rng is None:
        for f in range(0, hs + 1, 8):
            _filter_blocks(blocks[f:f + 8], srow[f:f + 8], scol[f:f + 8],
                           maxv)
    else:
        for k in rng.permutation((hs + 1) * (ws + 1)).tolist():
            f, e = divmod(k, ws + 1)
            _filter_blocks(blocks[f, e], srow[f, e], scol[f, e], maxv)
    area.copy_(p[2:H + 2, 2:W + 2])
    return area


def chroma_ver_ref(area, st, bd):
    """Edges at x = 2, 4, ... cascade left to right; one step per edge
    column, vectorised over rows."""
    maxv = (1 << bd) - 1
    p = area.to(torch.int32)
    s = st.repeat_interleave(2, dim=0)
    for e in range(1, p.shape[1] // 2):
        x = 2 * e
        p[:, x - 1], p[:, x] = _chroma_filter(p[:, x - 2], p[:, x - 1],
                                              p[:, x], p[:, x + 1], s[:, e],
                                              maxv)
    area.copy_(p)


def chroma_hor_ref(area, st, bd):
    maxv = (1 << bd) - 1
    p = area.to(torch.int32)
    s = st.repeat_interleave(2, dim=1)
    for e in range(1, p.shape[0] // 2):
        y = 2 * e
        p[y - 1], p[y] = _chroma_filter(p[y - 2], p[y - 1], p[y], p[y + 1],
                                        s[e], maxv)
    area.copy_(p)


def chroma_runs_ref(kind, area, st, bd, rng=None):
    """K9 in the order of its kernels (csrc/deblock.cu): the runs of
    consecutive edges with a strength, each filtered as one chain that
    carries A (the previous edge's new C) on both lines (columns) of its
    SCU row (column), the runs in any order -- a random one with `rng` (a
    numpy Generator).  Equal to `chroma_ver_ref` / `chroma_hor_ref` for
    every order: the statement that the runs are independent."""
    maxv = (1 << bd) - 1
    p = area.to(torch.int32)
    lines, s = (p, st) if kind == "chroma_ver" else (p.t(), st.t())
    on = (s > 0).clone()
    on[:, 0] = False                 # x = 0 (y = 0) is the area's side
    prev = torch.zeros_like(on)
    prev[:, 1:] = on[:, :-1]
    runs = []
    for r, e in (on & ~prev).nonzero().tolist():
        end = e
        while end < on.shape[1] and on[r, end]:
            end += 1
        runs.append((r, e, end))
    order = rng.permutation(len(runs)) if rng is not None else \
        range(len(runs))
    for k in order:
        r, e0, e1 = runs[k]
        ln = lines[2 * r:2 * r + 2]
        A = ln[:, 2 * e0 - 2].clone()
        for e in range(e0, e1):
            x = 2 * e
            B, C = _chroma_filter(A, ln[:, x - 1], ln[:, x], ln[:, x + 1],
                                  s[r, e].expand(2), maxv)
            ln[:, x - 1], ln[:, x] = B, C
            A = C
    area.copy_(p)


_REFS = {"luma_ver": luma_ver_ref, "luma_hor": luma_hor_ref,
         "chroma_ver": chroma_ver_ref, "chroma_hor": chroma_hor_ref}


def deblock_pass_ref(kind: str, area: torch.Tensor, st: torch.Tensor,
                     bd: int):
    """Plain version of `deblock_pass`: one area, or the areas of a GOP
    batch frame by frame."""
    if area.dim() == 2:
        _REFS[kind](area, st, bd)
    else:
        for g in range(area.shape[0]):
            _REFS[kind](area[g], st[g], bd)
    return area


def deblock_pass(kind: str, area: torch.Tensor, st: torch.Tensor, bd: int):
    """One pass ("luma_ver", "luma_hor", "chroma_ver", "chroma_hor") in
    place on `area` [H, W] int16 with strengths `st` [H/u, W/u] (u = 4
    luma, 2 chroma), or on the areas [G, H, W] of a GOP batch with
    strengths [G, H/u, W/u] (each map's rows contiguous).  A luma pass on
    the card is `deblock_luma` with the other map absent."""
    if kind == "luma_ver":
        return deblock_luma(area, st, None, bd)
    if kind == "luma_hor":
        return deblock_luma(area, None, st, bd)
    if kind not in ("chroma_ver", "chroma_hor"):
        raise ValueError(f"deblock pass {kind!r}")
    H, W = area.shape[-2:]
    lead = tuple(area.shape[:-2])
    if tuple(st.shape) != lead + (H // 2, W // 2) or H % 2 or W % 2 \
            or len(lead) > 1:
        raise ValueError(f"deblock {kind}: area {tuple(area.shape)} does not "
                         f"match strength map {tuple(st.shape)}")
    if area.device.type == "cpu":
        return deblock_pass_ref(kind, area, st, bd)
    nd = area.dim()
    K.require(area, torch.int16, nd, rows_contiguous=True)
    K.require(st, torch.int32, nd)
    if st.stride()[-2:] != (W // 2, 1):
        raise ValueError(f"deblock {kind}: strength map rows not contiguous")
    G = lead[0] if lead else 1
    fn = getattr(K.lib(), f"xevd_deblock_{kind}")
    K.count(f"deblock_{kind}")
    err = fn(area.data_ptr(), area.stride(-2), H, W, st.data_ptr(), bd, G,
             area.stride(0) if lead else 0, st.stride(0) if lead else 0,
             K.stream_ptr(area.device))
    K.check(err, f"xevd_deblock_{kind}")
    return area


def deblock_luma(area, st_ver, st_hor, bd):
    """K8: both luma passes (vertical edges, then horizontal) in place on
    `area` [H, W] int16 with the per-SCU strength maps st_ver, st_hor
    int32 [H/4, W/4], or on the areas [G, H, W] of a GOP batch with maps
    [G, H/4, W/4] (each map's rows contiguous); either map may be None (no
    edge of that direction).  CUDA tensors: one launch of csrc/deblock.cu
    `luma_kernel`, which reads the area as aligned 32-bit words -- an area
    that is not 4-byte aligned with an even row pitch (and batch stride)
    raises; CPU tensors: `luma_ver_ref`, then `luma_hor_ref`."""
    H, W = area.shape[-2:]
    lead = tuple(area.shape[:-2])
    maps = [m for m in (st_ver, st_hor) if m is not None]
    if not maps or len(lead) > 1 or H % 4 or W % 4 or any(
            tuple(m.shape) != lead + (H // 4, W // 4) for m in maps):
        raise ValueError(f"deblock_luma: area {tuple(area.shape)} does not "
                         f"match strength maps "
                         f"{[tuple(m.shape) for m in maps]}")
    if area.device.type == "cpu":
        for kind, st in (("luma_ver", st_ver), ("luma_hor", st_hor)):
            if st is not None:
                deblock_pass_ref(kind, area, st, bd)
        return area
    nd = area.dim()
    K.require(area, torch.int16, nd, rows_contiguous=True)
    for m in maps:
        K.require(m, torch.int32, nd)
        if m.stride()[-2:] != (W // 4, 1):
            raise ValueError("deblock_luma: strength map rows not contiguous")
    if area.data_ptr() % 4 or area.stride(-2) % 2 or (
            lead and area.stride(0) % 2):
        raise ValueError(f"deblock_luma: the area must be 4-byte aligned "
                         f"with an even row pitch (pitch "
                         f"{area.stride(-2)}, address {area.data_ptr():#x})")
    G = lead[0] if lead else 1

    def arg(m):
        return (None, 0) if m is None else (m.data_ptr(),
                                            m.stride(0) if lead else 0)
    (pv, bv), (ph, bh) = arg(st_ver), arg(st_hor)
    K.count("deblock_luma")
    err = K.lib().xevd_deblock_luma(
        area.data_ptr(), area.stride(-2), H, W, pv, ph, bd, G,
        area.stride(0) if lead else 0, bv, bh, K.stream_ptr(area.device))
    K.check(err, "xevd_deblock_luma")
    return area


def chroma_ver_ordered_ref(u, v, row_off, edges, bd):
    """K10's plain version, a literal port of the wave scan
    (xevd_tpu/ops/jax_deblock.py:122-166): wave k filters the edge of rank k
    of every SCU row that has one, on both chroma lines of the row and in
    both planes, vectorised over the rows.  row_off int32 [h_scu + 1],
    edges int32 [E, 3] (ops/pack.py `chroma_ver_edges`)."""
    maxv = (1 << bd) - 1
    off = row_off.to(torch.int64)
    cnt = off[1:] - off[:-1]
    pu, pv = u.to(torch.int32), v.to(torch.int32)
    for k in range(int(cnt.max()) if cnt.numel() else 0):
        rows = torch.nonzero(cnt > k).squeeze(1)
        e = edges[off[rows] + k].to(torch.int64)
        xx = e[:, 0]
        for p, st in ((pu, e[:, 1]), (pv, e[:, 2])):
            for dy in (0, 1):
                yy = 2 * rows + dy
                p[yy, xx - 1], p[yy, xx] = _chroma_filter(
                    p[yy, xx - 2], p[yy, xx - 1], p[yy, xx], p[yy, xx + 1],
                    st.to(torch.int32), maxv)
    u.copy_(pu)
    v.copy_(pv)


def suco_runs_plain(row_off, edges):
    """The runs of a SUCO edge table, stated plainly: for each SCU row and
    plane (0 U, 1 V), the columns whose edges have a strength in that
    plane, split where a column does not follow the previous one by 2
    samples; each run's edges in list order.  Returns [(row, plane,
    [(x, st), ...])] by row, plane and first column (the order of
    ops/pack.py `suco_runs`' table)."""
    off = [int(o) for o in row_off]
    ed = [tuple(int(c) for c in e) for e in edges]
    runs = []
    for r in range(len(off) - 1):
        row = ed[off[r]:off[r + 1]]
        for p in (0, 1):
            cols = sorted({x for x, *st in row if st[p] > 0})
            groups = []
            for x in cols:
                if groups and x == groups[-1][-1] + 2:
                    groups[-1].append(x)
                else:
                    groups.append([x])
            for g in groups:
                runs.append((r, p, [(x, st[p]) for x, *st in row
                                    if st[p] > 0 and x in g]))
    return runs


def chroma_ver_runs_ref(u, v, row_off, edges, bd, rng=None):
    """K10 in the order of its kernel (csrc/deblock.cu): the runs of
    `suco_runs_plain`, each walked as one chain in list order on both
    chroma lines of its SCU row, the runs in any order -- a random one
    with `rng` (a numpy Generator).  Equal to `chroma_ver_ordered_ref` for
    every order: the statement that the runs are independent (an edge at
    x reads x - 2 .. x + 1 and writes x - 1, x, so edges 4 or more
    samples apart touch disjoint samples)."""
    maxv = (1 << bd) - 1
    planes = (u.to(torch.int32), v.to(torch.int32))
    runs = suco_runs_plain(row_off, edges)
    order = rng.permutation(len(runs)) if rng is not None else \
        range(len(runs))
    for k in order:
        r, p, run = runs[k]
        ln = planes[p][2 * r:2 * r + 2]
        for x, st in run:
            ln[:, x - 1], ln[:, x] = _chroma_filter(
                ln[:, x - 2], ln[:, x - 1], ln[:, x], ln[:, x + 1],
                torch.full((2,), st, dtype=torch.int32), maxv)
    u.copy_(planes[0])
    v.copy_(planes[1])


def chroma_ver_ordered(u, v, row_off, edges, bd, runs=None):
    """K10: the SUCO-order chroma vertical edges, in place on the chroma
    areas u, v [H, W] int16 (H = 2 h_scu).  CUDA tensors launch
    csrc/deblock.cu `chroma_ver_runs_kernel` over `runs`, the table's run
    table on the device (ops/pack.py `SucoRuns`; a CUDA call without it
    raises); CPU tensors take `chroma_ver_ordered_ref`."""
    H, W = u.shape
    if v.shape != u.shape or row_off.shape != (H // 2 + 1,) or H % 2 \
            or edges.dim() != 2 or edges.shape[1] != 3:
        raise ValueError(f"chroma_ver_ordered: areas {tuple(u.shape)} "
                         f"{tuple(v.shape)}, row offsets "
                         f"{tuple(row_off.shape)}, edges {tuple(edges.shape)}")
    if u.device.type == "cpu":
        chroma_ver_ordered_ref(u, v, row_off, edges, bd)
        return u, v
    for a in (u, v):
        K.require(a, torch.int16, 2, rows_contiguous=True)
    if runs is None:
        raise ValueError("chroma_ver_ordered: a CUDA call needs the run "
                         "table (ops/pack.py suco_runs)")
    K.require(runs.row_runs, torch.int32, 1, contiguous=True)
    K.require(runs.run_off, torch.int32, 1, contiguous=True)
    K.require(runs.entries, torch.int32, 1, contiguous=True)
    if runs.row_runs.shape != (H + 1,):
        raise ValueError(f"chroma_ver_ordered: run rows "
                         f"{tuple(runs.row_runs.shape)} for {H // 2} SCU rows")
    if u.stride(0) != v.stride(0):
        raise ValueError("chroma_ver_ordered: u and v differ in row pitch")
    K.count("chroma_ver_ordered")
    err = K.lib().xevd_chroma_ver_ordered(
        u.data_ptr(), v.data_ptr(), u.stride(0), H, W,
        runs.row_runs.data_ptr(), runs.run_off.data_ptr(),
        runs.entries.data_ptr(), runs.row_runs_max, runs.row_entries_max, bd,
        K.stream_ptr(u.device))
    K.check(err, "xevd_chroma_ver_ordered")
    return u, v


def deblock_frame(y_area, u_area, v_area, st, bd, suco=None):
    """K12: luma (both passes, `deblock_luma`), chroma ver (u, v), chroma
    hor (u, v).  The reference order (xevd_tpu/ops/pipeline.py:299-309)
    runs luma ver, chroma ver, luma hor, chroma hor; chroma ver touches
    only U and V, so luma hor may run before it.
    st: int32 [6, h_scu, w_scu] = ver_y, hor_y, ver_u, hor_u, ver_v, hor_v.
    suco: (row_off, edges, runs) of a SUCO frame's chroma vertical edges
    (ops/pack.py `chroma_ver_edges`, `suco_runs`), which then run in that
    order (K10) instead of the raster pass.  u_area /
    v_area are None for 4:0:0.  A GOP batch: areas [G, H, W], st
    [G, 6, h_scu, w_scu], no SUCO."""
    if st.dim() == 4 and suco is not None:
        raise ValueError("deblock_frame: no SUCO order in a GOP batch")
    m = st.movedim(-3, 0)           # the six maps first, batch or not
    deblock_luma(y_area, m[0], m[1], bd)
    if u_area is not None and suco is not None:
        row_off, edges, runs = suco
        chroma_ver_ordered(u_area, v_area, row_off, edges, bd, runs=runs)
    elif u_area is not None:
        deblock_pass("chroma_ver", u_area, m[2], bd)
        deblock_pass("chroma_ver", v_area, m[4], bd)
    if u_area is not None:
        deblock_pass("chroma_hor", u_area, m[3], bd)
        deblock_pass("chroma_hor", v_area, m[5], bd)
