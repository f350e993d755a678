"""ADDB, the Main profile's advanced deblocking (the port of K11
`addb_luma_ver` / `addb_luma_hor` / `addb_chroma_ver` / `addb_chroma_hor`,
xevd_tpu/ops/jax_deblock.py:200-257, and of K12 `_deblock_finish_addb`,
xevd_tpu/ops/pipeline.py:250-281, which sequences them).

A pass filters an area in place (a strided view into the bordered picture
plane) with a per-SCU parameter map `pars` [H/4, W/4, C] (luma) or
[2 Hc/4, 2 Wc/4, C] (chroma): channel 0 is bs, channels cb, cb + 1, cb + 2
are (alpha, beta, c).  Edges sit on an 8-px luma grid (4-px chroma); a pass
has no cascade.  On CUDA tensors `addb_frame` launches csrc/addb.cu's one
kernel a picture, the six passes fused over shifted blocks
(`addb_blocks_ref` states the rule that makes this exact); on CPU tensors
it runs the `*_ref` plain passes in reference order, which run the line
filters of `host/ops/addb_common.py` (the ones the numpy oracle runs)
through `_XP`."""
from __future__ import annotations

import torch

from ..host.ops import addb_common as AC
from ..kernels import build as K


class _Tensor(torch.Tensor):
    """A tensor that answers `astype` as numpy and jax arrays do, the one
    array method addb_common calls (`ap.astype(c1.dtype)`)."""

    def astype(self, dtype):
        return self.to(dtype)


class _XP:
    """The array module addb_common is written against, over torch:
    `minimum` / `maximum` also take a Python scalar operand."""
    abs = staticmethod(torch.abs)
    where = staticmethod(torch.where)

    @staticmethod
    def minimum(a, b):
        return torch.minimum(*_tensors(a, b))

    @staticmethod
    def maximum(a, b):
        return torch.maximum(*_tensors(a, b))


def _tensors(a, b):
    like = a if isinstance(a, torch.Tensor) else b
    return tuple(x if isinstance(x, torch.Tensor)
                 else torch.tensor(x, dtype=like.dtype, device=like.device)
                 for x in (a, b))


def _taps(t):
    return t.to(torch.int32).as_subclass(_Tensor)


def _pars(sel, cb):
    return tuple(_taps(sel[..., c]) for c in (0, cb, cb + 1, cb + 2))


def luma_ver_ref(area, pars, bd, cb=1):
    """(xevd_tpu/ops/jax_deblock.py:200-214): edge left of each 8-col
    block; its parameters are pars[row >> 2, 2 e]."""
    H, W = area.shape
    p8 = area.to(torch.int32).reshape(H, W // 8, 8)
    p = tuple(_taps(p8[:, :-1, 7 - k]) for k in range(4))
    q = tuple(_taps(p8[:, 1:, k]) for k in range(4))
    sel = pars[:, ::2].repeat_interleave(4, dim=0)[:, 1:]
    (p0, p1, p2), (q0, q1, q2) = AC.luma_line(_XP, p, q, *_pars(sel, cb), bd)
    p8[:, :-1, 7], p8[:, :-1, 6], p8[:, :-1, 5] = p0, p1, p2
    p8[:, 1:, 0], p8[:, 1:, 1], p8[:, 1:, 2] = q0, q1, q2
    area.copy_(p8.reshape(H, W))


def luma_hor_ref(area, pars, bd, cb=1):
    """(:217-229): edge above each 8-row block; pars[2 e, col >> 2]."""
    H, W = area.shape
    p8 = area.to(torch.int32).reshape(H // 8, 8, W)
    p = tuple(_taps(p8[:-1, 7 - k, :]) for k in range(4))
    q = tuple(_taps(p8[1:, k, :]) for k in range(4))
    sel = pars[::2].repeat_interleave(4, dim=1)[1:]
    (p0, p1, p2), (q0, q1, q2) = AC.luma_line(_XP, p, q, *_pars(sel, cb), bd)
    p8[:-1, 7, :], p8[:-1, 6, :], p8[:-1, 5, :] = p0, p1, p2
    p8[1:, 0, :], p8[1:, 1, :], p8[1:, 2, :] = q0, q1, q2
    area.copy_(p8.reshape(H, W))


def chroma_ver_ref(area, pars, bd, cb=1):
    """(:232-244): 4:2:0 chroma, edge left of each 4-col block;
    pars[row >> 1, 2 e]."""
    H, W = area.shape
    p4 = area.to(torch.int32).reshape(H, W // 4, 4)
    p = (_taps(p4[:, :-1, 3]), _taps(p4[:, :-1, 2]))
    q = (_taps(p4[:, 1:, 0]), _taps(p4[:, 1:, 1]))
    sel = pars[:, ::2].repeat_interleave(2, dim=0)[:, 1:]
    p0, q0 = AC.chroma_line(_XP, p, q, *_pars(sel, cb), bd)
    p4[:, :-1, 3], p4[:, 1:, 0] = p0, q0
    area.copy_(p4.reshape(H, W))


def chroma_hor_ref(area, pars, bd, cb=1):
    """(:247-257): edge above each 4-row block; pars[2 e, col >> 1]."""
    H, W = area.shape
    p4 = area.to(torch.int32).reshape(H // 4, 4, W)
    p = (_taps(p4[:-1, 3, :]), _taps(p4[:-1, 2, :]))
    q = (_taps(p4[1:, 0, :]), _taps(p4[1:, 1, :]))
    sel = pars[::2].repeat_interleave(2, dim=1)[1:]
    p0, q0 = AC.chroma_line(_XP, p, q, *_pars(sel, cb), bd)
    p4[:-1, 3, :], p4[1:, 0, :] = p0, q0
    area.copy_(p4.reshape(H, W))


_REFS = {"luma_ver": luma_ver_ref, "luma_hor": luma_hor_ref,
         "chroma_ver": chroma_ver_ref, "chroma_hor": chroma_hor_ref}
# (block size of the edge grid, samples of the plane per map cell)
_GRID = {"luma_ver": (8, 4), "luma_hor": (8, 4), "chroma_ver": (4, 2),
         "chroma_hor": (4, 2)}


def addb_pass(kind: str, area: torch.Tensor, pars: torch.Tensor, bd: int,
              cb: int = 1):
    """One plain ADDB pass ("luma_ver", "luma_hor", "chroma_ver",
    "chroma_hor") in place on the CPU tensor `area` [H, W] int16,
    parameters `pars` [H/u, W/u, C] int32 (u = 4 luma, 2 chroma) with
    (alpha, beta, c) at channels cb..cb + 2.  No kernel runs one pass:
    a CUDA tensor raises (`addb_frame` launches the fused kernel)."""
    blk, u = _GRID[kind]
    H, W = area.shape
    if (pars.dim() != 3 or pars.shape[:2] != (H // u, W // u) or H % blk
            or W % blk or not 1 <= cb <= pars.shape[2] - 3):
        raise ValueError(f"addb {kind}: area {tuple(area.shape)} does not "
                         f"match parameter map {tuple(pars.shape)} (cb {cb})")
    if area.device.type != "cpu":
        raise ValueError(f"addb {kind}: no per-pass kernel; addb_frame "
                         "launches the fused one")
    _REFS[kind](area, pars, bd, cb)
    return area


def addb_frame_ref(y_area, u_area, v_area, luma_pars, chroma_pars, bd):
    """The plain version of `addb_frame`: the passes in reference order --
    luma ver, chroma ver (u, v), luma hor, chroma hor (u, v)
    (xevd_tpu/ops/pipeline.py:250-281), on any device."""
    luma_ver_ref(y_area, luma_pars[0], bd)
    if u_area is not None:
        chroma_ver_ref(u_area, chroma_pars[0], bd, 1)
        chroma_ver_ref(v_area, chroma_pars[0], bd, 4)
    luma_hor_ref(y_area, luma_pars[1], bd)
    if u_area is not None:
        chroma_hor_ref(u_area, chroma_pars[1], bd, 1)
        chroma_hor_ref(v_area, chroma_pars[1], bd, 4)


def _block_lines(a, pars, B, cb, r, c, bd):
    """Shifted block (r, c) of the int32 plane `a`: rows and columns
    [B r - B/2, B r + B/2) x [B c - B/2, B c + B/2), cut to the plane;
    its vertical edge (x = B c) on each of its rows, then its horizontal
    edge (y = B r) on each of its columns, edges 1 .. n - 1 of the plane
    only."""
    H, W = a.shape
    h2, us = B // 2, 2 if B == 8 else 1
    fil = AC.luma_line if B == 8 else AC.chroma_line
    y0, y1 = max(B * r - h2, 0), min(B * r + h2, H)
    x0, x1 = max(B * c - h2, 0), min(B * c + h2, W)
    for d, e, n, lines, span in ((0, c, W // B, a[y0:y1], (y0, y1)),
                                 (1, r, H // B, a[:, x0:x1].t(), (x0, x1))):
        if not 1 <= e < n or lines.shape[0] == 0:
            continue
        cells = torch.arange(*span, device=a.device) >> us
        sel = pars[0][cells, 2 * c] if d == 0 else pars[1][2 * r, cells]
        x = B * e
        p = tuple(_taps(lines[:, x - 1 - k]) for k in range(h2))
        q = tuple(_taps(lines[:, x + k]) for k in range(h2))
        out = fil(_XP, p, q, *_pars(sel, cb), bd)
        if B == 8:
            (p0, p1, p2), (q0, q1, q2) = out
            lines[:, x - 1], lines[:, x - 2], lines[:, x - 3] = p0, p1, p2
            lines[:, x], lines[:, x + 1], lines[:, x + 2] = q0, q1, q2
        else:
            lines[:, x - 1], lines[:, x] = out


def addb_blocks_ref(y_area, u_area, v_area, luma_pars, chroma_pars, bd,
                    order=None):
    """ADDB in the order of csrc/addb.cu: each shifted block of each plane
    (luma 8 x 8 shifted by 4, chroma 4 x 4 shifted by 2) filtered vertical
    edge, then horizontal edge, the blocks of the three planes in raster
    order, or in a random order drawn from `order` (a numpy Generator).
    Equal to `addb_frame_ref` for every order: the statement that the
    shifted blocks are independent and closed under "ver, then hor"."""
    planes = [(y_area, luma_pars, 8, 1)]
    if u_area is not None:
        planes += [(u_area, chroma_pars, 4, 1), (v_area, chroma_pars, 4, 4)]
    work = [a.to(torch.int32) for a, _, _, _ in planes]
    blocks = [(i, r, c) for i, (a, _, B, _) in enumerate(planes)
              for r in range(a.shape[0] // B + 1)
              for c in range(a.shape[1] // B + 1)]
    if order is not None:
        blocks = [blocks[k] for k in order.permutation(len(blocks))]
    for i, r, c in blocks:
        _, pars, B, cb = planes[i]
        _block_lines(work[i], pars, B, cb, r, c, bd)
    for (a, _, _, _), w in zip(planes, work):
        a.copy_(w)


def _wide(t, nbytes):
    """The area's base and row pitch are aligned for `nbytes`-byte words."""
    return t.data_ptr() % nbytes == 0 and t.stride(0) * 2 % nbytes == 0


def addb_frame(y_area, u_area, v_area, luma_pars, chroma_pars, bd):
    """K12 with ADDB on the areas in place: luma_pars [2, hs2, ws2, 4],
    chroma_pars [2, hs2, ws2, 7] ([0] vertical, [1] horizontal edges); U
    reads chroma channels (0, 1, 2, 3), V (0, 4, 5, 6).  The areas are the
    H8 x W8 crops (H8 = 4 hs2), which may reach one SCU past the SCU grid;
    u_area / v_area are None for 4:0:0.  CUDA tensors: one launch of the
    fused kernel, which reads an area as aligned words where its base and
    pitch allow, else sample by sample; CPU tensors: `addb_frame_ref`."""
    H, W = y_area.shape
    chroma = u_area is not None
    if (H % 8 or W % 8
            or tuple(luma_pars.shape) != (2, H // 4, W // 4, 4)
            or (chroma and (tuple(chroma_pars.shape) != (2, H // 4, W // 4, 7)
                            or tuple(u_area.shape) != (H // 2, W // 2)
                            or tuple(v_area.shape) != (H // 2, W // 2)))):
        raise ValueError(f"addb: areas {tuple(y_area.shape)} do not match "
                         f"the maps {tuple(luma_pars.shape)}, "
                         f"{getattr(chroma_pars, 'shape', None)}")
    if y_area.device.type == "cpu":
        addb_frame_ref(y_area, u_area, v_area, luma_pars, chroma_pars, bd)
        return
    areas = (y_area, u_area, v_area) if chroma else (y_area,)
    for a in areas:
        K.require(a, torch.int16, 2, rows_contiguous=True)
    K.require(luma_pars, torch.int32, 4, contiguous=True)
    if chroma:
        K.require(chroma_pars, torch.int32, 4, contiguous=True)
    wide = sum(int(_wide(a, 8 if i == 0 else 4)) << i
               for i, a in enumerate(areas))
    u, v = ((a.data_ptr(), a.stride(0)) if chroma else (None, 0)
            for a in (u_area, v_area))
    K.count("addb_frame")
    err = K.lib().xevd_addb_frame(
        y_area.data_ptr(), y_area.stride(0), *u, *v, H, W,
        luma_pars.data_ptr(), chroma_pars.data_ptr() if chroma else None,
        wide, bd,
        K.stream_ptr(y_area.device))
    K.check(err, "xevd_addb_frame")
