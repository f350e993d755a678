"""Fractional-pel motion compensation of a frame's inter blocks into int32
prediction and count planes (the port of K3 `mc_bucket`,
xevd_tpu/ops/jax_mc.py:50, fused with K4 `_mc_all`,
xevd_tpu/ops/pipeline.py:179).

`mc_all` launches the CUDA kernel (csrc/mc.cu) once per reference list over
the frame's MC block table (ops/pack.py `pack_mc`), its rows grouped by
class (`mc_order`, built by the pack), for CUDA reference planes, and runs
`mc_all_ref`, the plain PyTorch version, for CPU ones.  With CUDA planes
every operand, the block table, its class order and the tap tables
included, must be on the card.  `main_taps` (a Main stream with ADMVP)
selects the Main tap tables; the arithmetic is the same
(xevd_tpu/ops/jax_mc.py:61-66).  With `mc_off` the table holds the blocks
of the G frames of one time step of a GOP batch (K15), still one launch
per list (`mc_all_batch_ref` on the CPU); its references are the batch's
DPB ring (`DpbRing`), addressed by the ring's strides."""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from ..kernels import build as K
from .pack import (MAX_REF_SLOTS, MC_CASE, MC_GX, MC_GY, MC_H, MC_PLANE,
                   MC_PX, MC_PY, MC_SLOT, MC_W, McOrder)


@dataclass(frozen=True)
class DpbRing:
    """The references of one time step t of a GOP batch (K15): the DPB
    ring, one tensor int16 [D, G_dev, H, W] a plane (y, u, v; u, v None for
    4:0:0), step s written into entry s mod D.  Reference slot
    (d - 1) * G_dev + g is GOP g's picture d steps back: ring entry
    ((t - d) mod D, g).  Any D x G_dev."""
    planes: tuple
    t: int

    @property
    def D(self) -> int:
        return self.planes[0].shape[0]

    @property
    def Gd(self) -> int:
        return self.planes[0].shape[1]

    def stacks(self):
        """The D x G_dev slots' planes stacked in slot order, [R, H, W] a
        plane (None for 4:0:0): the plain version's view of the ring."""
        s = torch.arange(self.D * self.Gd, device=self.planes[0].device)
        d = s // self.Gd + 1
        return [None if p is None else p[(self.t - d) % self.D, s % self.Gd]
                for p in self.planes]


def _taps(tables, is_luma, main_taps):
    return tables[("mc_l" if is_luma else "mc_c")
                  + ("_main" if main_taps else "")]


def mc_blocks_ref(refs, slot, gx, gy, case, w, h, bd, is_luma, tables,
                  main_taps=False):
    """refs int16 [R, H, W]; slot, gx, gy [N] -> int32 [N, h, w], clipped
    to [0, 2^bd - 1] (case 00 copies).  gx, gy are 1/16-pel (luma) or
    1/32-pel (chroma) positions from the padded plane origin; `case` (0 =
    00, 1 = N0, 2 = 0N, 3 = NN) chooses the filters, whatever the phase:
    a clipped MV can give phase 0 with taps, and tap row 0 then runs.
    N0 and 0N round nothing; NN truncates its intermediate to int16 (a
    wrap) and rounds (ref: xevd_tpu/ops/jax_mc.py:50-96).  `main_taps`
    takes the Main (ADMVP) tap tables."""
    fbits, ntap = (4, 8) if is_luma else (5, 4)
    tbl = _taps(tables, is_luma, main_taps)
    dev = refs.device
    slot, gx, gy = (t.to(dev, torch.int64) for t in (slot, gx, gy))
    half = ntap // 2 - 1
    maxv = (1 << bd) - 1
    taps_x, taps_y = case & 1, case & 2
    x0 = (gx >> fbits) - (half if taps_x else 0)
    y0 = (gy >> fbits) - (half if taps_y else 0)
    ww = w + (ntap - 1 if taps_x else 0)
    wh = h + (ntap - 1 if taps_y else 0)
    win = refs[slot[:, None, None],
               y0[:, None, None] + torch.arange(wh, device=dev)[None, :, None],
               x0[:, None, None] + torch.arange(ww, device=dev)[None, None, :]
               ].to(torch.int32)
    if case == 0:
        return win
    tx = tbl[gx & ((1 << fbits) - 1)].to(dev)[:, :, None, None]  # [N,ntap,1,1]
    ty = tbl[gy & ((1 << fbits) - 1)].to(dev)[:, :, None, None]
    if case == 1:
        acc = sum(tx[:, k] * win[:, :, k:k + w] for k in range(ntap))
        return (acc >> 6).clamp(0, maxv)
    if case == 2:
        acc = sum(ty[:, k] * win[:, k:k + h, :] for k in range(ntap))
        return (acc >> 6).clamp(0, maxv)
    shift1 = min(4, bd - 8)
    shift2 = max(8, 20 - bd)
    buf = sum(tx[:, k] * win[:, :, k:k + w] for k in range(ntap))
    buf = (buf >> shift1).to(torch.int16).to(torch.int32)
    acc = sum(ty[:, k] * buf[:, k:k + h, :] for k in range(ntap))
    return ((acc + (1 << (shift2 - 1))) >> shift2).clamp(0, maxv)


def _new_planes(shp_y, shp_c, device, lead=()):
    """Zero (pred_y, cnt_y, pred_u, pred_v, cnt_c); chroma None for 4:0:0.
    Intra CUs, and L1-only CUs in list 0, keep zero.  The planes are
    16-byte aligned views into one zeroed buffer: one fill a call."""
    shapes = [(lead + shp_y, torch.int32), (lead + shp_y, torch.int8)]
    if shp_c is not None:
        shapes += [(lead + shp_c, torch.int32), (lead + shp_c, torch.int32),
                   (lead + shp_c, torch.int8)]
    sizes = [math.prod(s) * dt.itemsize for s, dt in shapes]
    buf = torch.zeros(sum(-(-n // 16) * 16 for n in sizes), dtype=torch.uint8,
                      device=device)
    planes, off = [], 0
    for (s, dt), n in zip(shapes, sizes):
        planes.append(buf[off:off + n].view(dt).view(s))
        off += -(-n // 16) * 16
    return tuple(planes) + (None,) * (5 - len(planes))


def _ref_stacks(refs):
    """The slots' planes stacked, [R, H, W] per plane (None for 4:0:0)."""
    return [None if refs[0][i] is None else torch.stack([r[i] for r in refs])
            for i in range(3)]


def mc_all_ref(mc, refs, shp_y, shp_c, bd, tables, main_taps=False):
    """Plain version of `mc_all`: rows grouped by (plane, w, h, case), each
    group predicted by `mc_blocks_ref` and scatter-added into the planes,
    its count plane by one (ref: xevd_tpu/ops/pipeline.py:179-215)."""
    planes = _new_planes(shp_y, shp_c, refs[0][0].device)
    _mc_rows_ref(planes, mc, _ref_stacks(refs), bd, tables, main_taps)
    return planes


def mc_all_batch_ref(mc, mc_off, ring: DpbRing, shp_y, shp_c, bd, tables,
                     main_taps=False):
    """Plain version of the batched `mc_all`: frame g's rows of both lists
    (mc_off, ops/pack.py `stack_frames`) through `mc_all_ref`'s loop into
    the planes [g], each slot read from its ring entry; returns [G, ...]
    planes."""
    off = mc_off.cpu().tolist()
    G, n0 = len(off[0]) - 1, off[0][-1]
    planes = _new_planes(shp_y, shp_c, ring.planes[0].device, (G,))
    stacks = ring.stacks()
    for g in range(G):
        rows = torch.cat([mc[off[0][g]:off[0][g + 1]],
                          mc[n0 + off[1][g]:n0 + off[1][g + 1]]])
        _mc_rows_ref([None if p is None else p[g] for p in planes], rows,
                     stacks, bd, tables, main_taps)
    return planes


def _mc_rows_ref(planes, mc, stacks, bd, tables, main_taps):
    """Add the predictions and counts of the block table `mc` into
    `planes` (pred_y, cnt_y, pred_u, pred_v, cnt_c), from the stacked
    reference planes."""
    pred_y, cnt_y, pred_u, pred_v, cnt_c = planes
    dev = pred_y.device
    rows = mc.cpu().to(torch.int64)
    keys = (rows[:, MC_PLANE] << 20 | rows[:, MC_W] << 12 | rows[:, MC_H] << 4
            | rows[:, MC_CASE])
    for key in torch.unique(keys).tolist():
        sel = rows[(keys == key).nonzero()[:, 0]].to(dev)
        plane, w, h, case = key >> 20, (key >> 12) & 255, (key >> 4) & 255, \
            key & 15
        yy = sel[:, MC_PY, None, None] + torch.arange(h, device=dev)[
            None, :, None]
        xx = sel[:, MC_PX, None, None] + torch.arange(w, device=dev)[
            None, None, :]
        args = (sel[:, MC_SLOT], sel[:, MC_GX], sel[:, MC_GY], case, w, h, bd,
                plane == 0, tables, main_taps)
        if plane == 0:
            pred_y.index_put_((yy, xx), mc_blocks_ref(stacks[0], *args),
                              accumulate=True)
            cnt = cnt_y
        else:
            pred_u.index_put_((yy, xx), mc_blocks_ref(stacks[1], *args),
                              accumulate=True)
            pred_v.index_put_((yy, xx), mc_blocks_ref(stacks[2], *args),
                              accumulate=True)
            cnt = cnt_c
        cnt.index_put_((yy, xx), torch.ones((), dtype=torch.int8, device=dev)
                       .expand(yy.shape[0], h, w), accumulate=True)


def mc_all(mc, lists, refs, shp_y, shp_c, bd, tables, main_taps=False,
           mc_off=None, order: McOrder | None = None):
    """mc: int32 [N, 10] MC block table (ops/pack.py), `lists` = (rows of
    list 0, rows of list 1), list 0 first; refs: per slot a (y, u, v)
    tuple of padded int16 reference planes (u, v None for 4:0:0);
    `main_taps`: the Main (ADMVP) filters.  Returns (pred_y, cnt_y,
    pred_u, pred_v, cnt_c): int32 prediction sums and int8 counts over
    bordered planes of shapes shp_y / shp_c.  A GOP batch of G frames:
    `mc_off` int32 [2, G + 1], frame g's rows of list l at
    mc_off[l, g]:mc_off[l, g + 1] from the list's first row, refs a
    `DpbRing`, and the planes [G, ...].  `order`: the kernel's launches
    over the rows by class (ops/pack.py `mc_order`, on the device as the
    pack uploads it, with each row's frame g in a batch), which CUDA
    planes need; the plain version needs none."""
    if (mc_off is not None) != isinstance(refs, DpbRing):
        raise ValueError("mc_all: a GOP batch (mc_off) reads a DpbRing, a "
                         "frame a per-slot plane list")
    if not isinstance(refs, DpbRing) and not refs:
        raise ValueError("mc_all: no reference planes")
    ref0 = refs.planes[0] if isinstance(refs, DpbRing) else refs[0][0]
    if ref0.device.type == "cpu":
        if mc_off is not None:
            return mc_all_batch_ref(mc, mc_off, refs, shp_y, shp_c, bd,
                                    tables, main_taps)
        return mc_all_ref(mc, refs, shp_y, shp_c, bd, tables, main_taps)
    return _mc_cuda(mc, lists, refs, shp_y, shp_c, bd, tables, main_taps,
                    mc_off, order)


def _require_words(p):
    """The kernel reads reference rows as aligned 32-bit words: a plane
    4-byte aligned, with even pitch and strides."""
    if p.data_ptr() % 4 or any(s % 2 for s in p.stride()[:-1]):
        raise ValueError("mc_all: a reference plane not 4-byte aligned or "
                         "with an odd pitch")


def _ref_pointers(refs, i):
    """ctypes array of the slots' plane-i pointers, and their row pitch;
    every plane must have the same shape."""
    planes = [r[i] for r in refs]
    for p in planes:
        K.require(p, torch.int16, 2, contiguous=True)
        _require_words(p)
    if len({tuple(p.shape) for p in planes}) != 1:
        raise ValueError("mc_all: reference planes differ in shape")
    arr = (ctypes.c_void_p * MAX_REF_SLOTS)(*[p.data_ptr() for p in planes])
    return arr, planes[0].stride(0)


def _mc_cuda(mc, lists, refs, shp_y, shp_c, bd, tables, main_taps, mc_off,
             order):
    if order is None:
        raise ValueError("mc_all: the kernel needs the rows' class order "
                         "(ops/pack.py mc_order)")
    chroma = shp_c is not None
    batched = mc_off is not None
    taps_l = _taps(tables, True, main_taps)
    taps_c = _taps(tables, False, main_taps)
    K.require(mc, torch.int32, 2, contiguous=True)
    for t in (taps_l, taps_c):
        K.require(t, torch.int32, 2, contiguous=True)
        if t.data_ptr() % 16:
            raise ValueError("mc_all: tap table not 16-byte aligned")
    if batched:
        K.require(mc_off, torch.int32, 2, contiguous=True)
    if mc.shape[1] != 10:
        raise ValueError(f"MC table wants 10 columns, got {tuple(mc.shape)}")
    n0, n1 = lists
    if n0 + n1 != mc.shape[0]:
        raise ValueError(f"MC lists {lists} != {mc.shape[0]} table rows")
    K.require(order.order, torch.int32, 2, contiguous=True)
    K.require(order.classes, torch.int32, 2, contiguous=True)
    if (order.order.shape != (mc.shape[0], 2)
            or order.classes.shape[1] != 4
            or sum(k for _, k, _ in order.lists) != order.classes.shape[0]):
        raise ValueError(f"mc_all: class order {tuple(order.order.shape)} / "
                         f"{tuple(order.classes.shape)} / {order.lists} for "
                         f"{mc.shape[0]} rows")
    lib = K.lib()
    if batched:
        refs_args, pitch_y, pitch_c = _ring_args(refs, chroma)
        entry = lib.xevd_mc_ring
    else:
        if len(refs) > MAX_REF_SLOTS:
            raise ValueError(f"{len(refs)} reference slots > "
                             f"{MAX_REF_SLOTS}")
        if chroma != (refs[0][1] is not None):
            raise ValueError("mc_all: chroma reference planes and shp_c "
                             "disagree")
        ref_y, pitch_y = _ref_pointers(refs, 0)
        ref_u, pitch_c = _ref_pointers(refs, 1) if chroma else (None, 0)
        ref_v, _ = _ref_pointers(refs, 2) if chroma else (None, 0)
        if chroma and refs[0][1].shape != refs[0][2].shape:
            raise ValueError("mc_all: u and v reference planes differ in "
                             "shape")
        refs_args = (ref_y, ref_u, ref_v, len(refs))
        entry = lib.xevd_mc
    G = mc_off.shape[1] - 1 if batched else 1
    pred_y, cnt_y, pred_u, pred_v, cnt_c = planes = _new_planes(
        shp_y, shp_c, mc.device, (G,) if batched else ())
    stream = K.stream_ptr(mc.device)
    add = 0
    for k0, n_cls, n_cta in order.lists:
        if n_cta == 0:
            continue
        K.count("mc")
        err = entry(
            mc.data_ptr(), order.order.data_ptr(),
            order.classes.data_ptr() + 16 * k0, n_cls, n_cta, *refs_args,
            pitch_y, pitch_c, pred_y.data_ptr(),
            pred_u.data_ptr() if chroma else None,
            pred_v.data_ptr() if chroma else None, cnt_y.data_ptr(),
            cnt_c.data_ptr() if chroma else None, pred_y.stride(-2),
            pred_u.stride(-2) if chroma else 0, taps_l.data_ptr(),
            taps_c.data_ptr(), bd, add,
            pred_y.stride(0) if batched else 0,
            pred_u.stride(0) if batched and chroma else 0, stream)
        K.check(err, entry.__name__)
        add = 1        # the first launch stored into the zero planes
    return planes


def _ring_args(ring: DpbRing, chroma: bool):
    """The ring's arguments of `xevd_mc_ring` (base pointers, strides
    over entries and GOPs, D, G_dev, t) and the row pitches."""
    y, u, v = ring.planes
    if chroma != (u is not None):
        raise ValueError("mc_all: chroma reference planes and shp_c disagree")
    for p in (y, u, v):
        if p is not None:
            K.require(p, torch.int16, 4, rows_contiguous=True)
            _require_words(p)
    if chroma and (u.shape != v.shape or u.stride() != v.stride()):
        raise ValueError("mc_all: u and v rings differ in shape or strides")
    if chroma and u.shape[:2] != y.shape[:2]:
        raise ValueError("mc_all: the rings' D x G_dev differ")
    return ((y.data_ptr(), u.data_ptr() if chroma else None,
             v.data_ptr() if chroma else None, y.stride(0), y.stride(1),
             u.stride(0) if chroma else 0, u.stride(1) if chroma else 0,
             ring.D, ring.Gd, ring.t),
            y.stride(2), u.stride(2) if chroma else 0)
