"""Shared numpy-seeded inputs of the tests/test_torch_*.py files (planes,
TU, CU and MC tables, deblock strengths) and the kernel-against-plain-
version cases that both tests/test_torch_cuda.py and chip_smoke.py run on
the card.  Imports no JAX, so it also serves on a machine without JAX."""
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable

import numpy as np
import torch

from xevd_tpu import tables as T
from xevd_tpu.ops.ref_numpy import qp_scale
from xevd_tpu_torch.ops import deblock as TD
from xevd_tpu_torch.ops import intra as TI
from xevd_tpu_torch.ops import intra_main as TIM
from xevd_tpu_torch.ops import itdq as TQ
from xevd_tpu_torch.ops import mc as TM
from xevd_tpu_torch.ops import pack as PK
from xevd_tpu_torch.ops import recon as TR
from xevd_tpu_torch.ops.tables import (BORDER, PAD_C, PAD_L, PAD_R,
                                       device_tables)
from xevd_tpu_torch.plane import DevicePlane


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


def itdq_frame(bd, h=64, w=128, chroma=True, seed=0, coef_max=3000,
               main=False):
    """Random coefficient planes in [-coef_max, coef_max) and a quadtree TU
    table (comp, log2w, log2h, scale, y, x, trs) covering them, with the
    bordered plane shapes.  `main`: Main scales (DQ_SCALE), and luma TUs
    up to 32 wide take a random ATS trs (or 0, the DCT-2)."""
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
                trs = (int(rng.choice([0, 5, 6, 9, 10]))
                       if main and comp == 0 and lg <= 5 else 0)
                rows.append((comp, lg, lg, qp_scale(qp, main), y, x, trs))
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


def _btt(rng, cus, p=0.3):
    """Split some squares of a z-order (y, x, log2) list in two halves (a
    binary split, decode order kept): (y, x, log2w, log2h) rows."""
    out = []
    for y, x, lg in cus:
        if lg >= 3 and rng.random() < p:
            if rng.random() < 0.5:          # two (w, h / 2) halves
                h = 1 << (lg - 1)
                out += [(y, x, lg, lg - 1), (y + h, x, lg, lg - 1)]
            else:                           # two (w / 2, h) halves
                w = 1 << (lg - 1)
                out += [(y, x, lg - 1, lg), (y, x + w, lg - 1, lg)]
        else:
            out.append((y, x, lg, lg))
    return out


def eipd_scene(H, W, bd, seed, chroma=True, htdf=True):
    """A synthetic EIPD frame over an H x W picture (multiples of 64):
    random bordered planes and residuals, and a z-order CU list (4..64,
    square and binary-split rectangles) with random modes, chroma modes and
    trees (mostly 0, some TREE_L / TREE_C), and, with `htdf`, some
    HTDF-only inter CUs and HTDF on a share of the CUs.  Neighbour masks,
    left/right availability and the HTDF ring bits are set where the cell
    was written by an earlier CU, as a decoder sets them; the levels come
    from `xevd_tpu.ops.wavefront.level_scan_cus`.  Returns (recs, res,
    table, level_off) as `pack_intra_main` would (numpy)."""
    from types import SimpleNamespace

    from xevd_tpu.ops.wavefront import level_scan_cus

    rng = np.random.default_rng(seed)
    maxv = (1 << bd) - 1
    recs = [bordered(rng, H, W, 0, maxv + 1)]
    recs += [bordered(rng, H // 2, W // 2, 0, maxv + 1) for _ in range(2)]
    res = [bordered(rng, H, W, -600, 600)]
    res += [bordered(rng, H // 2, W // 2, -600, 600) for _ in range(2)]
    res[0][BORDER, BORDER] = 32767     # int16 wrap of pred + resid
    cus = _btt(rng, quadtree(rng, H, W, 6, 2))
    hs, ws = H >> 2, W >> 2
    done = np.zeros((hs, ws), bool)

    def cell(cy, cx):
        return 0 <= cy < hs and 0 <= cx < ws and bool(done[cy, cx])

    def bits(cells):
        return sum(1 << u for u, c in enumerate(cells) if c)

    rows = []
    for y, x, lw, lh in cus:
        ys, xs, sw, sh = y >> 2, x >> 2, 1 << (lw - 2), 1 << (lh - 2)
        nu = sw + sh
        up = bits(cell(ys - 1, xs + u) for u in range(nu))
        left = bits(cell(ys + u, xs - 1) for u in range(nu))
        right = bits(cell(ys + u, xs + sw) for u in range(nu))
        corner = int(cell(ys - 1, xs - 1))
        lr = int(cell(ys, xs - 1)) | (2 * int(cell(ys, xs + sw)))
        intra = not htdf or rng.random() > 0.2
        tree = int(rng.choice([0, 1, 2], p=[0.8, 0.1, 0.1])) if intra else 0
        hidx = int(rng.integers(0, 5)) if htdf and (
            not intra or rng.random() < 0.4) else -1
        ring = (cell(ys, xs - 1), cell(ys, xs + sw), cell(ys - 1, xs),
                corner, cell(ys - 1, xs + sw), cell(ys + sh, xs - 1),
                cell(ys + sh, xs + sw))
        rows.append((x, y, lw, lh, int(rng.integers(0, 33)),
                     int(rng.integers(0, 5)),
                     np.uint32(up).astype(np.int32),
                     np.uint32(left).astype(np.int32),
                     np.uint32(right).astype(np.int32), corner, lr, tree, 1,
                     int(intra), hidx, bits(ring)))
        done[ys:ys + sh, xs:xs + sw] = True
    a = np.array(rows, np.int64)
    fs = SimpleNamespace(h_scu=hs, w_scu=ws, cu_x=a[:, 0], cu_y=a[:, 1],
                         cu_log2w=a[:, 2], cu_log2h=a[:, 3], cu_tree=a[:, 11],
                         cu_pred_mode=np.where(a[:, 13] == 1, T.MODE_INTRA,
                                               T.MODE_INTER))
    job = SimpleNamespace(cu_nbr_up=a[:, 6] & 0xFFFFFFFF,
                          cu_nbr_left=a[:, 7] & 0xFFFFFFFF,
                          cu_nbr_right=a[:, 8] & 0xFFFFFFFF,
                          cu_nbr_upext=np.zeros(len(a), np.int64),
                          cu_nbr_corner=a[:, 9].astype(np.uint8),
                          cu_htdf_idx=a[:, 14] if htdf else None)
    levels = np.asarray(level_scan_cus(fs, job, np.arange(len(a)), chroma))
    table = a[:, :16 if htdf else 13].astype(np.int32)
    order = np.argsort(levels, kind="stable")
    level_off = np.concatenate([[0], np.cumsum(np.bincount(levels))])
    return (recs, res, np.ascontiguousarray(table[order]),
            level_off.astype(np.int32), table, levels)


def captured_frames(stream, device="cpu"):
    """Decode `stream` (a path) with the torch backend on `device`; every
    frame's (job, sps, refp, PackedFrame)."""
    from xevd_tpu import NAL_UNIT_LENGTH_BYTE, Decoder, info
    from xevd_tpu_torch import TorchPixelBackend

    class Capture(TorchPixelBackend):
        def __init__(self):
            super().__init__(device=device)
            self.frames = []

        def pack_frame(self, job, sps, refp):
            pf = super().pack_frame(job, sps, refp)
            self.frames.append((job, sps, refp, pf))
            return pf

    backend = Capture()
    dec = Decoder(backend=backend)
    data = stream.read_bytes()
    pos = 0
    while pos + NAL_UNIT_LENGTH_BYTE <= len(data):
        ln, _, _ = info(data[pos:pos + 6])
        dec.decode(data[pos + 4:pos + 4 + ln])
        pos += 4 + ln
    dec._drain_pipeline()
    return backend.frames


def planes_before_intra(pf, dev):
    """(recs, resids, df): a packed frame's bordered picture planes after
    ITDQ, MC and recon, the planes its intra stage starts from, on `dev`
    (ops/pipeline.residuals_and_recon, as the main path runs it); u/v
    None for 4:0:0."""
    from xevd_tpu_torch.ops.pipeline import residuals_and_recon

    df = PK.upload(pf, dev)
    resids, recs = residuals_and_recon(df, device_tables(dev))
    return list(recs), list(resids), df


def mc_frame(H, W, bd, chroma=True, seed=0, device="cpu"):
    """A synthetic inter frame over an H x W picture, as the decoder hands
    it to a backend: (fs, job, refp).  CUs tile the picture in z-order
    (8..64), a tenth of them intra; each inter CU has refi -1, 0 or 1 in
    each list (never both -1) and quarter-pel MVs up to +-600, so the MV
    clip acts near the edges and a clipped MV keeps its filter case.  A
    fifth of the bi CUs repeat L0's motion on the same picture in L1 (the
    identical-motion skip).  References: two random padded pictures A and
    B as DevicePlanes on `device`, lists L0 = (A, B), L1 = (B, A)."""
    rng = np.random.default_rng(seed)
    cus = np.array(quadtree(rng, H, W, 6, 3), np.int64)    # (y, x, log2)
    m = len(cus)
    mode = np.where(rng.random(m) < 0.1, T.MODE_INTRA, T.MODE_INTER)
    refi = rng.integers(-1, 2, size=(m, 2))
    refi[(refi[:, 0] < 0) & (refi[:, 1] < 0), 0] = 0
    mv = rng.integers(-600, 600, size=(m, 2, 2))
    same = (rng.random(m) < 0.2) & (refi[:, 0] >= 0)
    refi[same, 1] = 1 - refi[same, 0]
    mv[same, 1] = mv[same, 0]
    ctu = 64
    fs = SimpleNamespace(
        cu_x=cus[:, 1], cu_y=cus[:, 0], cu_log2w=cus[:, 2],
        cu_log2h=cus[:, 2], cu_pred_mode=mode, w=W, h=H,
        w_pad=-(-W // ctu) * ctu, h_pad=-(-H // ctu) * ctu)
    job = SimpleNamespace(cu_refi=refi.astype(np.int32),
                          cu_mv=mv.astype(np.int32))

    def picture(poc):
        def plane(h, w, pad):
            return DevicePlane(torch.from_numpy(rng.integers(
                0, 1 << bd, size=(h + 2 * pad, w + 2 * pad)).astype(
                    np.int16)).to(device))
        pic = SimpleNamespace(y=plane(H, W, PAD_L), u=None, v=None)
        if chroma:
            pic.u = plane(H // 2, W // 2, PAD_C)
            pic.v = plane(H // 2, W // 2, PAD_C)
        return SimpleNamespace(poc=poc, pic=pic)
    a, b = picture(0), picture(4)
    return fs, job, [[a, b], [b, a]]


def mc_shapes(fs, chroma):
    """Bordered pred-plane shapes of a frame (as ops/pack.py builds them)."""
    shp_y = (BORDER + fs.h_pad + PAD_R, BORDER + fs.w_pad + PAD_R)
    shp_c = ((BORDER + (fs.h_pad >> 1) + PAD_R,
              BORDER + (fs.w_pad >> 1) + PAD_R) if chroma else None)
    return shp_y, shp_c


def mc_blocks(rng, n, is_luma, case, sizes, refs_hw, frac0=0.25):
    """n random block positions (slot, gx, gy) of one case in two padded
    reference planes of shape refs_hw, every window inside; a share
    `frac0` of the filtering blocks has phase 0, as a clipped MV gives."""
    fbits, half, ntap = (4, 3, 8) if is_luma else (5, 1, 4)
    H, W = refs_hw
    w, h = sizes
    slot = rng.integers(0, 2, n)
    ix = rng.integers(half, W - w - ntap + half + 1, n)
    iy = rng.integers(half, H - h - ntap + half + 1, n)
    fx = rng.integers(0, 1 << fbits, n) * (case & 1 != 0)
    fy = rng.integers(0, 1 << fbits, n) * (case & 2 != 0)
    fx[rng.random(n) < frac0] = 0
    fy[rng.random(n) < frac0] = 0
    return slot, (ix << fbits) + fx, (iy << fbits) + fy


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


def itdq_case(dev, bd, h, w, chroma=True, seed=0, coef_max=3000, iqt=False):
    """A frame's TU table over h x w coefficient planes; `iqt`: the Main
    transforms, with ATS bases on some luma TUs."""
    coefs, tus, shp_y, shp_c = itdq_frame(bd, h, w, chroma, seed, coef_max,
                                          main=iqt)
    tc = [_dev(c, dev) for c in coefs] + [None] * (3 - len(coefs))
    args = (tc, _dev(tus, dev), shp_y, shp_c, bd, device_tables(dev), iqt)
    return KernelCase("itdq", f"{h}x{w} bd{bd}{' iqt+ATS' if iqt else ''}, "
                      f"{len(tus)} TUs",
                      lambda: TQ.itdq(*args), lambda: TQ.itdq_ref(*args))


def itdq_size_case(dev, bd, log2, n=64, seed=0, iqt=False, trs=0):
    """n TUs of one size (2^log2 square) with coefficients over the whole
    int16 range, so the dequant and stage clips are hit; `iqt` / `trs` the
    Main DCT-2 / an ATS basis pair (log2 <= 5)."""
    rng = np.random.default_rng(seed + 16 * log2 + bd + trs)
    s = 1 << log2
    coef = rng.integers(-32768, 32768, size=(s * 8, s * (n // 8)))
    qps = rng.integers(0, 52 + 6 * (bd - 8), size=n)
    main = bool(iqt or trs)
    tus = np.array([(0, log2, log2, qp_scale(int(qps[i]), main), (i % 8) * s,
                     (i // 8) * s, trs) for i in range(n)], np.int32)
    shp = (BORDER + s * 8 + PAD_R, BORDER + s * (n // 8) + PAD_R)
    args = ([_dev(coef.astype(np.int16), dev), None, None], _dev(tus, dev),
            shp, None, bd, device_tables(dev), iqt)
    kind = f" trs {trs}" if trs else (" iqt" if iqt else "")
    return KernelCase("itdq", f"{s}x{s} bd{bd}{kind}, {n} TUs",
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


def intra_wave_planes_case(dev, recs, res, icu, level_off, bd, chroma,
                           shape):
    """The EIPD wavefront scan on device planes `recs` (left untouched:
    each side scans a copy of its own) with residuals `res`, CU table
    `icu` and host level offsets `level_off`."""
    tab = device_tables(dev)
    a = [None if r is None else r.clone() for r in recs]
    b = [None if r is None else r.clone() for r in recs]
    return KernelCase(
        "intra_scan_wave", shape,
        lambda: list(TIM.intra_scan_wave(a, res, icu, level_off, bd, chroma,
                                         tab)),
        lambda: list(TIM.intra_scan_wave_ref(b, res, icu, level_off, bd,
                                             chroma)))


def intra_wave_case(dev, H, W, bd, chroma=True, seed=0, htdf=True):
    """A synthetic EIPD frame (`eipd_scene`) over H x W."""
    recs, res, icu, level_off, _, _ = eipd_scene(H, W, bd, seed, chroma,
                                                  htdf)
    return intra_wave_planes_case(
        dev, [_dev(p, dev) for p in recs], [_dev(p, dev) for p in res],
        _dev(icu, dev), torch.from_numpy(level_off), bd, chroma,
        f"{H}x{W} bd{bd}{'' if chroma else ' luma'}"
        f"{' htdf' if htdf else ''}, {len(icu)} CUs, "
        f"{len(level_off) - 1} levels")


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


def mc_case(dev, H, W, bd, chroma=True, seed=0):
    """MC of a synthetic inter frame (`mc_frame`), packed by ops/pack.py,
    with every case, both lists and the identical-motion skip."""
    fs, job, refp = mc_frame(H, W, bd, chroma, seed, dev)
    table, lists, refs = PK.pack_mc(fs, job, refp, chroma)
    return mc_table_case(dev, table, lists, refs, *mc_shapes(fs, chroma), bd,
                         f"{H}x{W} bd{bd}{'' if chroma else ' luma'}, "
                         f"{lists[0]}+{lists[1]} blocks, {len(refs)} slots")


def mc_table_case(dev, table, lists, refs, shp_y, shp_c, bd, shape,
                  main_taps=False):
    """The MC kernel and its plain version on one block table (int32
    [N, 10], host or device) and per-slot reference planes on `dev`."""
    tab = device_tables(dev)
    mc = _dev(np.asarray(table, np.int32), dev) if isinstance(
        table, np.ndarray) else table
    return KernelCase(
        "mc", shape,
        lambda: list(TM.mc_all(mc, lists, refs, shp_y, shp_c, bd, tab,
                               main_taps)),
        lambda: list(TM.mc_all_ref(mc, refs, shp_y, shp_c, bd, tab,
                                   main_taps)))


def mc_size_case(dev, is_luma, case, bd, seed=0, main_taps=False):
    """Blocks of one plane group and case at every size (luma 4..64,
    chroma 2..32, square and not), in both lists over the same cells (so
    cnt reaches 2), from two reference slots whose second plane holds
    samples over the whole int16 range (the NN intermediate wraps)."""
    rng = np.random.default_rng(seed + 7 * case + bd + (100 if is_luma else 0))
    smax = 64 if is_luma else 32
    sizes = [(s, s) for s in (smax >> 4, smax >> 3, smax >> 2, smax >> 1,
                              smax)] + [(smax >> 1, smax >> 3),
                                        (smax >> 4, smax >> 2)]
    hw = (3 * smax, 4 * smax)
    planes = [rng.integers(0, 1 << bd, size=hw),
              rng.integers(-32768, 32768, size=hw)]
    # per slot (y, u, v); a chroma row reads u and v, here two different
    # planes (y is unused by chroma rows)
    refs = [tuple(None if i and is_luma else
                  _dev(np.ascontiguousarray(q).astype(np.int16), dev)
                  for i, q in enumerate((p, p, p[::-1])))
            for p in planes]
    cells = 4
    rows = []
    for lidx in (0, 1):
        for k, (w, h) in enumerate(sizes):
            slot, gx, gy = mc_blocks(rng, cells, is_luma, case, (w, h), hw)
            for c in range(cells):
                rows.append((0 if is_luma else 1, w, h, case, slot[c], gx[c],
                             gy[c], BORDER + c * smax, BORDER + k * smax,
                             lidx))
    table = np.array(rows, np.int32)
    shp = (BORDER + cells * smax + PAD_R, BORDER + len(sizes) * smax + PAD_R)
    n = len(rows) // 2
    return mc_table_case(
        dev, table, (n, n), refs, shp, None if is_luma else shp, bd,
        f"{'luma' if is_luma else 'chroma'} case {case} bd{bd}"
        f"{' Main taps' if main_taps else ''}, {len(rows)} blocks",
        main_taps)


def recon_pred_planes(bd, H=96, W=160, seed=0):
    """resid int16, pred int32 and cnt int8 [H, W]: cnt in {0, 1, 2}, pred
    up to 2^17 so that pred + resid leaves the int16 range (the wrap)."""
    rng = np.random.default_rng(seed + bd)
    resid = rng.integers(-32768, 32768, size=(H, W)).astype(np.int16)
    pred = rng.integers(0, 1 << 17, size=(H, W)).astype(np.int32)
    pred[: H // 2] >>= 7                 # half the plane in a normal range
    cnt = rng.integers(0, 3, size=(H, W)).astype(np.int8)
    return resid, pred, cnt


def recon_pred_case(dev, bd, H, W, seed=0):
    resid, pred, cnt = (_dev(a, dev) for a in recon_pred_planes(bd, H, W,
                                                                  seed))
    return KernelCase("recon", f"{H}x{W} bd{bd} with prediction",
                      lambda: [TR.recon(resid, bd, pred, cnt)],
                      lambda: [TR.recon_ref(resid, bd, pred, cnt)])
