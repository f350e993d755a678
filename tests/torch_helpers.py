"""Shared numpy-seeded inputs of the tests/test_torch_*.py files (planes,
TU and CU tables, deblock strengths) and the kernel-against-plain-version
cases that both tests/test_torch_cuda.py and chip_smoke.py run on the card.
Imports no JAX, so it also serves on a machine without JAX."""
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from xevd_tpu.ops.ref_numpy import qp_scale
from xevd_tpu_torch.ops import deblock as TD
from xevd_tpu_torch.ops import intra as TI
from xevd_tpu_torch.ops import itdq as TQ
from xevd_tpu_torch.ops import recon as TR
from xevd_tpu_torch.ops.tables import BORDER, PAD_R, device_tables


def quadtree(rng, H, W, log2_max, log2_min):
    """Random square tiling of [H, W] in z-order (decode order of a
    quadtree): list of (y, x, log2).  Blocks that cross the picture edge
    split, blocks outside it are dropped, as at a boundary CTU."""
    out = []

    def split(y, x, log2):
        if y >= H or x >= W:
            return
        size = 1 << log2
        crosses = y + size > H or x + size > W
        if log2 > log2_min and (crosses or log2 == log2_max
                                and rng.random() < 0.8
                                or rng.random() < 0.5):
            h = 1 << (log2 - 1)
            for dy, dx in ((0, 0), (0, h), (h, 0), (h, h)):
                split(y + dy, x + dx, log2 - 1)
        else:
            out.append((y, x, log2))

    s = 1 << log2_max
    for y in range(0, H, s):
        for x in range(0, W, s):
            split(y, x, log2_max)
    return out


def bordered(rng, h, w, lo, hi, dtype=np.int16):
    """A [BORDER + h + PAD_R, BORDER + w + PAD_R] plane of random samples
    in [lo, hi) everywhere (the border too)."""
    return rng.integers(lo, hi, size=(BORDER + h + PAD_R, BORDER + w + PAD_R)
                        ).astype(dtype)


def itdq_frame(bd, h=64, w=128, chroma=True, seed=0, coef_max=3000):
    """Random coefficient planes in [-coef_max, coef_max) and a quadtree TU
    table (comp, log2w, log2h, scale, y, x) covering them, with the
    bordered plane shapes."""
    rng = np.random.default_rng(seed + bd)
    coefs = [rng.integers(-coef_max, coef_max, size=(h, w)).astype(np.int16)]
    comps = [(0, h, w, 6, 2)]
    if chroma:
        coefs += [rng.integers(-coef_max, coef_max, size=(h // 2, w // 2))
                  .astype(np.int16) for _ in range(2)]
        comps += [(1, h // 2, w // 2, 5, 1), (2, h // 2, w // 2, 5, 1)]
    rows = []
    for comp, hh, ww, lmax, lmin in comps:
        for y, x, lg in quadtree(rng, hh, ww, lmax, lmin):
            if rng.random() < 0.8:           # some TUs have no residual
                qp = int(rng.integers(0, 52 + 6 * (bd - 8)))
                rows.append((comp, lg, lg, qp_scale(qp), y, x))
    tus = np.array(rows, np.int32)
    shp_y = (BORDER + h + PAD_R, BORDER + w + PAD_R)
    shp_c = (BORDER + h // 2 + PAD_R, BORDER + w // 2 + PAD_R) if chroma \
        else None
    return coefs, tus, shp_y, shp_c


def recon_planes(bd, H=96, W=160, seed=0):
    """int16 residual planes, luma and two chroma, over the whole int16
    range (both clip bounds are hit)."""
    rng = np.random.default_rng(seed + bd)
    return [rng.integers(-32768, 32768, size=(h, w)).astype(np.int16)
            for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]


def intra_scene(H, W, bd, seed):
    """Random bordered planes, residuals and a z-order CU table (x, y,
    log2, ipm, up_mask, left_mask, corner, valid) covering the picture."""
    rng = np.random.default_rng(seed)
    maxv = (1 << bd) - 1
    recs = [bordered(rng, H, W, 0, maxv + 1)]
    recs += [bordered(rng, H // 2, W // 2, 0, maxv + 1) for _ in range(2)]
    res = [bordered(rng, H, W, -600, 600)]
    res += [bordered(rng, H // 2, W // 2, -600, 600) for _ in range(2)]
    res[0][BORDER, BORDER] = 32767     # int16 wrap of pred + resid
    rows = []
    for y, x, lg in quadtree(rng, H, W, 6, 3):
        rows.append((x, y, lg, int(rng.integers(0, 5)),
                     int(rng.integers(-2 ** 31, 2 ** 31)),
                     int(rng.integers(-2 ** 31, 2 ** 31)),
                     int(rng.integers(0, 2)), int(rng.random() > 0.05)))
    return recs, res, np.array(rows, np.int32)


def strengths(rng, h_scu, w_scu, n=1):
    """Per-SCU deblock strengths [n, h_scu, w_scu]: mostly 0 (no edge),
    some in 1..12."""
    st = rng.integers(1, 13, size=(n, h_scu, w_scu))
    return (st * (rng.random((n, h_scu, w_scu)) < 0.6)).astype(np.int32)


# --------------------------------------------------------------------------
# kernel-against-plain-version cases (run on a CUDA device)
# --------------------------------------------------------------------------
@dataclass
class KernelCase:
    """One kernel and its plain version on equal inputs on `dev`.  Each
    callable returns its output tensors.  In-place ops work on buffers of
    their own, so the first call of each is the one to compare; later
    calls only time."""
    name: str                 # launch-counter name (kernels/build.py)
    shape: str                # what the inputs are, for a log line
    kernel: Callable
    plain: Callable


def max_abs_err(got, want) -> int:
    """Largest |got - want| over two equal-length sequences of tensors
    (None where a plane is absent, e.g. 4:0:0 chroma)."""
    err = 0
    for g, w in zip(got, want, strict=True):
        if (g is None) != (w is None):
            raise AssertionError("one side has a plane the other lacks")
        if g is None:
            continue
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max().item()))
    return err


def compare(case: KernelCase) -> int:
    """Runs the kernel and the plain version once each; max abs error."""
    got = case.kernel()
    want = case.plain()
    torch.cuda.synchronize()
    return max_abs_err(got, want)


def _dev(a, dev):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)
                                                   ).to(dev)


def itdq_case(dev, bd, h, w, chroma=True, seed=0, coef_max=3000):
    """A frame's TU table over h x w coefficient planes."""
    coefs, tus, shp_y, shp_c = itdq_frame(bd, h, w, chroma, seed, coef_max)
    tc = [_dev(c, dev) for c in coefs] + [None] * (3 - len(coefs))
    args = (tc, _dev(tus, dev), shp_y, shp_c, bd, device_tables(dev))
    return KernelCase("itdq", f"{h}x{w} bd{bd}, {len(tus)} TUs",
                      lambda: TQ.itdq(*args), lambda: TQ.itdq_ref(*args))


def itdq_size_case(dev, bd, log2, n=64, seed=0):
    """n TUs of one size (2^log2 square) with coefficients over the whole
    int16 range, so the dequant and stage-0 clips are hit."""
    rng = np.random.default_rng(seed + 16 * log2 + bd)
    s = 1 << log2
    coef = rng.integers(-32768, 32768, size=(s * 8, s * (n // 8)))
    qps = rng.integers(0, 52 + 6 * (bd - 8), size=n)
    tus = np.array([(0, log2, log2, qp_scale(int(qps[i])), (i % 8) * s,
                     (i // 8) * s) for i in range(n)], np.int32)
    shp = (BORDER + s * 8 + PAD_R, BORDER + s * (n // 8) + PAD_R)
    args = ([_dev(coef.astype(np.int16), dev), None, None], _dev(tus, dev),
            shp, None, bd, device_tables(dev))
    return KernelCase("itdq", f"{s}x{s} bd{bd}, {n} TUs",
                      lambda: TQ.itdq(*args), lambda: TQ.itdq_ref(*args))


def recon_case(dev, bd, H, W, seed=0):
    resid = _dev(recon_planes(bd, H, W, seed)[0], dev)
    return KernelCase("recon", f"{H}x{W} bd{bd}",
                      lambda: [TR.recon(resid, bd)],
                      lambda: [TR.recon_ref(resid, bd)])


def pad_case(dev, bd, h, w, pad, seed=0):
    """Pad-expand of the h x w picture from a view into a bordered plane
    (a row pitch), as the pipeline calls it."""
    rng = np.random.default_rng(seed + bd)
    plane = _dev(bordered(rng, h, w, 0, 1 << bd), dev)
    area = plane[BORDER:BORDER + h, BORDER:BORDER + w]
    return KernelCase("pad", f"{h}x{w} +{pad} bd{bd}",
                      lambda: [TR.pad(area, h, w, pad)],
                      lambda: [TR.pad_ref(area, h, w, pad)])


def intra_planes_case(dev, recs, res, icu, bd, chroma, shape):
    """The intra scan on device planes `recs` (left untouched: each side
    scans a copy of its own) with residuals `res` and CU table `icu`."""
    a = [None if r is None else r.clone() for r in recs]
    b = [None if r is None else r.clone() for r in recs]
    return KernelCase(
        "intra_scan", shape,
        lambda: list(TI.intra_scan(a, res, icu, bd, chroma)),
        lambda: list(TI.intra_scan_ref(b, res, icu, bd, chroma)))


def intra_case(dev, H, W, bd, chroma=True, seed=0):
    """A random z-order CU list with random neighbour masks over H x W."""
    recs, res, icu = intra_scene(H, W, bd, seed)
    return intra_planes_case(
        dev, [_dev(p, dev) for p in recs], [_dev(p, dev) for p in res],
        _dev(icu, dev), bd, chroma,
        f"{H}x{W} bd{bd}{'' if chroma else ' luma'}, {len(icu)} CUs")


def deblock_case(dev, kind, bd, h_scu, w_scu, seed=0):
    """One pass in place on the SCU-area view of a bordered plane (as the
    pipeline calls it); each side filters a plane of its own."""
    rng = np.random.default_rng(seed + bd + len(kind))
    u = 4 if kind.startswith("luma") else 2
    base = bordered(rng, h_scu * u, w_scu * u, 0, 1 << bd)
    st = _dev(strengths(rng, h_scu, w_scu)[0], dev)
    a, b = _dev(base, dev), _dev(base, dev)
    sl = (slice(BORDER, BORDER + h_scu * u), slice(BORDER, BORDER + w_scu * u))

    def kernel():
        TD.deblock_pass(kind, a[sl], st, bd)
        return [a]

    def plain():
        TD._REFS[kind](b[sl], st, bd)
        return [b]
    return KernelCase(f"deblock_{kind}", f"{h_scu * u}x{w_scu * u} bd{bd}",
                      kernel, plain)
