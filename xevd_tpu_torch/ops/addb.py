"""ADDB, the Main profile's advanced deblocking (the port of K11
`addb_luma_ver` / `addb_luma_hor` / `addb_chroma_ver` / `addb_chroma_hor`,
xevd_tpu/ops/jax_deblock.py:200-257, and of K12 `_deblock_finish_addb`,
xevd_tpu/ops/pipeline.py:250-281, which sequences them).

Every pass filters an area in place (a strided view into the bordered
picture plane) with a per-SCU parameter map `pars` [H/4, W/4, C] (luma) or
[2 Hc/4, 2 Wc/4, C] (chroma): channel 0 is bs, channels cb, cb + 1, cb + 2
are (alpha, beta, c).  Edges sit on an 8-px luma grid (4-px chroma); a pass
has no cascade.  CUDA tensors launch the kernels of csrc/addb.cu; CPU
tensors take the `*_ref` plain versions, which run the line filters of
`host/ops/addb_common.py` (the ones the numpy oracle runs) through `_XP`."""
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
    """One ADDB pass ("luma_ver", "luma_hor", "chroma_ver", "chroma_hor")
    in place on `area` [H, W] int16, parameters `pars` [H/u, W/u, C] int32
    (u = 4 luma, 2 chroma) with (alpha, beta, c) at channels cb..cb + 2."""
    blk, u = _GRID[kind]
    H, W = area.shape
    if (pars.dim() != 3 or pars.shape[:2] != (H // u, W // u) or H % blk
            or W % blk or not 1 <= cb <= pars.shape[2] - 3):
        raise ValueError(f"addb {kind}: area {tuple(area.shape)} does not "
                         f"match parameter map {tuple(pars.shape)} (cb {cb})")
    if area.device.type == "cpu":
        _REFS[kind](area, pars, bd, cb)
        return area
    K.require(area, torch.int16, 2, rows_contiguous=True)
    K.require(pars, torch.int32, 3, contiguous=True)
    K.count(f"addb_{kind}")
    err = getattr(K.lib(), f"xevd_addb_{kind}")(
        area.data_ptr(), area.stride(0), H, W, pars.data_ptr(),
        pars.shape[2], cb, bd, K.stream_ptr(area.device))
    K.check(err, f"xevd_addb_{kind}")
    return area


def addb_frame(y_area, u_area, v_area, luma_pars, chroma_pars, bd):
    """K12 with ADDB: the passes in reference order -- luma ver, chroma ver
    (u, v), luma hor, chroma hor (u, v) (xevd_tpu/ops/pipeline.py:250-281).
    luma_pars [2, hs2, ws2, 4], chroma_pars [2, hs2, ws2, 7] ([0] vertical,
    [1] horizontal edges); U reads chroma channels (0, 1, 2, 3), V (0, 4,
    5, 6).  The areas are the H8 x W8 crops (H8 = 4 hs2), which may reach
    one SCU past the SCU grid; u_area / v_area are None for 4:0:0."""
    addb_pass("luma_ver", y_area, luma_pars[0], bd)
    if u_area is not None:
        addb_pass("chroma_ver", u_area, chroma_pars[0], bd, 1)
        addb_pass("chroma_ver", v_area, chroma_pars[0], bd, 4)
    addb_pass("luma_hor", y_area, luma_pars[1], bd)
    if u_area is not None:
        addb_pass("chroma_hor", u_area, chroma_pars[1], bd, 1)
        addb_pass("chroma_hor", v_area, chroma_pars[1], bd, 4)
