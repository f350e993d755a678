"""Baseline deblocking (the port of K8 `luma_ver_pass` / `luma_hor_pass`,
K9 `chroma_ver_pass` / `chroma_hor_pass`, K10 `chroma_ver_ordered`,
xevd_tpu/ops/jax_deblock.py:59-188, and of K12 `_deblock_finish`,
xevd_tpu/ops/pipeline.py:285, which sequences them).

Every pass filters an SCU-cropped area in place (a strided view into the
bordered picture plane).  `st` is the per-SCU strength map
int32 [h_scu, w_scu] (0 = no edge).  CUDA tensors launch the kernels of
csrc/deblock.cu; CPU tensors take the `*_ref` plain versions."""
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


_REFS = {"luma_ver": luma_ver_ref, "luma_hor": luma_hor_ref,
         "chroma_ver": chroma_ver_ref, "chroma_hor": chroma_hor_ref}
# SCU size in samples of the plane each pass filters
_SCU = {"luma_ver": 4, "luma_hor": 4, "chroma_ver": 2, "chroma_hor": 2}


def deblock_pass(kind: str, area: torch.Tensor, st: torch.Tensor, bd: int):
    """One pass ("luma_ver", "luma_hor", "chroma_ver", "chroma_hor") in
    place on `area` [H, W] int16 with strengths `st` [H/u, W/u] (u = 4
    luma, 2 chroma)."""
    u = _SCU[kind]
    H, W = area.shape
    if st.shape != (H // u, W // u) or H % u or W % u:
        raise ValueError(f"deblock {kind}: area {tuple(area.shape)} does not "
                         f"match strength map {tuple(st.shape)}")
    if area.device.type == "cpu":
        _REFS[kind](area, st, bd)
        return area
    K.require(area, torch.int16, 2, rows_contiguous=True)
    K.require(st, torch.int32, 2, contiguous=True)
    fn = getattr(K.lib(), f"xevd_deblock_{kind}")
    K.count(f"deblock_{kind}")
    err = fn(area.data_ptr(), area.stride(0), H, W, st.data_ptr(), bd,
             K.stream_ptr(area.device))
    K.check(err, f"xevd_deblock_{kind}")
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


def chroma_ver_ordered(u, v, row_off, edges, bd):
    """K10: the SUCO-order chroma vertical edges, in place on the chroma
    areas u, v [H, W] int16 (H = 2 h_scu).  CUDA tensors launch
    csrc/deblock.cu `chroma_ver_ordered_kernel`, CPU tensors take
    `chroma_ver_ordered_ref`."""
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
    K.require(row_off, torch.int32, 1, contiguous=True)
    K.require(edges, torch.int32, 2, contiguous=True)
    if u.stride(0) != v.stride(0):
        raise ValueError("chroma_ver_ordered: u and v differ in row pitch")
    K.count("chroma_ver_ordered")
    err = K.lib().xevd_chroma_ver_ordered(
        u.data_ptr(), v.data_ptr(), u.stride(0), H, row_off.data_ptr(),
        edges.data_ptr(), bd, K.stream_ptr(u.device))
    K.check(err, "xevd_chroma_ver_ordered")
    return u, v


def deblock_frame(y_area, u_area, v_area, st, bd, suco=None):
    """K12: the passes in reference order -- luma ver, chroma ver (u, v),
    luma hor, chroma hor (u, v) (ref: xevd_tpu/ops/pipeline.py:299-309).
    st: int32 [6, h_scu, w_scu] = ver_y, hor_y, ver_u, hor_u, ver_v, hor_v.
    suco: (row_off, edges) of a SUCO frame's chroma vertical edges, which
    then run in that order (K10) instead of the raster pass.  u_area /
    v_area are None for 4:0:0."""
    deblock_pass("luma_ver", y_area, st[0], bd)
    if u_area is not None and suco is not None:
        chroma_ver_ordered(u_area, v_area, *suco, bd)
    elif u_area is not None:
        deblock_pass("chroma_ver", u_area, st[2], bd)
        deblock_pass("chroma_ver", v_area, st[4], bd)
    deblock_pass("luma_hor", y_area, st[1], bd)
    if u_area is not None:
        deblock_pass("chroma_hor", u_area, st[3], bd)
        deblock_pass("chroma_hor", v_area, st[5], bd)
