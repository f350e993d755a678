"""Shared numpy-seeded inputs of the tests/test_torch_*.py files (planes,
TU, CU and MC tables, deblock strengths) and the kernel-against-plain-
version cases that both tests/test_torch_cuda.py and chip_smoke.py run on
the card.  Imports neither JAX nor `xevd_tpu` (host code comes from the
port's own copy, `xevd_tpu_torch.host`), so it also serves on a machine
without JAX."""
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable

import numpy as np
import torch

from xevd_tpu_torch.host import tables as T
from xevd_tpu_torch.host.ops.ref_numpy import qp_scale
from xevd_tpu_torch.ops import addb as TA
from xevd_tpu_torch.ops import alf as TL
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
    from `xevd_tpu_torch.host.ops.wavefront.level_scan_cus`.  Returns (recs, res,
    table, level_off) as `pack_intra_main` would (numpy)."""
    from types import SimpleNamespace

    from xevd_tpu_torch.host.ops.wavefront import level_scan_cus

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
    from xevd_tpu_torch import TorchPixelBackend
    from xevd_tpu_torch.host import NAL_UNIT_LENGTH_BYTE, Decoder, info

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


def suco_edges(rng, h_scu, w_scu, max_edges=5):
    """A SUCO chroma edge table as ops/pack.py `chroma_ver_edges` returns it
    (row_off int32 [h_scu + 1], edges int32 [E, 3] = (x, st_u, st_v)): up
    to `max_edges` edges a SCU row at random SCU columns 1..w_scu - 1 in a
    random order (repeats and neighbours cascade), each with a strength
    in 1..12 in U, V or both."""
    rows, edges = [], []
    for r in range(h_scu):
        for _ in range(int(rng.integers(0, max_edges + 1))):
            su, sv = (int(rng.integers(1, 13)) * int(rng.random() < 0.7)
                      for _ in range(2))
            if su == sv == 0:
                su = 3
            rows.append(r)
            edges.append((2 * int(rng.integers(1, w_scu)), su, sv))
    row_off = np.concatenate([[0], np.cumsum(np.bincount(
        np.asarray(rows, np.int64), minlength=h_scu))]).astype(np.int32)
    return row_off, np.asarray(edges, np.int32).reshape(-1, 3)


def smooth_plane(rng, h, w, bd, noise=3):
    """int16 [h, w]: a slow gradient over the whole sample range plus
    +-noise steps per 4x4 block and per sample (clipped), so that deblock
    filters decide both ways and both clips are reached."""
    maxv = (1 << bd) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy + xx) * (maxv + 40) // max(h + w - 2, 1) - 20
    s = 1 << (bd - 8)
    blocks = rng.integers(-4 * noise, 4 * noise + 1,
                          size=(-(-h // 4), -(-w // 4)))
    base = base + s * np.kron(blocks, np.ones((4, 4), np.int64))[:h, :w]
    base = base + s * rng.integers(-noise, noise + 1, size=(h, w))
    return np.clip(base, 0, maxv).astype(np.int16)


def addb_pars(rng, hs, ws, bd, nch=4):
    """An ADDB parameter map int32 [2, hs, ws, nch]: bs in 0..4 (a third 0,
    a quarter 4), then (alpha, beta, c) triples scaled to the bit depth as
    the derive scales them, so that filters apply and skip."""
    s = 1 << (bd - 8)
    out = np.zeros((2, hs, ws, nch), np.int32)
    out[..., 0] = rng.choice([0, 1, 2, 3, 4], size=(2, hs, ws),
                             p=[0.3, 0.15, 0.15, 0.15, 0.25])
    for c in range(1, nch, 3):
        out[..., c] = rng.integers(0, 40, size=(2, hs, ws)) * s
        out[..., c + 1] = rng.integers(0, 18, size=(2, hs, ws)) * s
        out[..., c + 2] = rng.integers(0, 12, size=(2, hs, ws)) * s
    return out


def alf_coefs(rng):
    """(coef_l int32 [25, 13], coef_c int32 [7]): random taps with the
    centre tap completing 512, as host/ops/alf.py reconstructs them."""
    cl = rng.integers(-48, 49, size=(25, 13))
    cl[:, 12] = 512 - 2 * cl[:, :12].sum(1)
    cc = rng.integers(-48, 49, size=7)
    cc[6] = 512 - 2 * cc[:6].sum()
    return cl.astype(np.int32), cc.astype(np.int32)


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
    bytes: int = 0            # each input read once, each output written once
    ops: int = 0              # integer operations these inputs need


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


def _host(t) -> np.ndarray:
    return np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)


def itdq_work(tus):
    """(bytes, ops) of the ITDQ of a TU table: each TU's coefficients read
    and residuals written once (int16), a dequant and two separable stages
    of w * h * (w + h) multiply-adds."""
    t = _host(tus).astype(np.int64)
    w, h = 1 << t[:, PK.TU_LOG2W], 1 << t[:, PK.TU_LOG2H]
    n = w * h
    return int(4 * n.sum() + t.size * 4), int((2 * n * (w + h) + 4 * n).sum())


def mc_work(table):
    """(bytes, ops) of MC over a block table: each block's reference window
    (taps included) read, its int32 prediction and int8 count written (two
    planes for a chroma row), 2 operations a tap and pass per sample."""
    t = _host(table).astype(np.int64)
    luma = t[:, PK.MC_PLANE] == 0
    ntap = np.where(luma, 8, 4)
    planes = np.where(luma, 1, 2)
    cx, cy = (t[:, PK.MC_CASE] & 1) != 0, (t[:, PK.MC_CASE] & 2) != 0
    w, h = t[:, PK.MC_W], t[:, PK.MC_H]
    win = (w + cx * (ntap - 1)) * (h + cy * (ntap - 1))
    n = w * h
    taps = np.maximum(1, 2 * ntap * (cx.astype(np.int64) + cy))
    return (int((planes * (2 * win + 5 * n)).sum() + t.size * 4),
            int((planes * n * taps).sum()))


def intra_work(icu, log2w, log2h, chroma):
    """(bytes, ops) of an intra scan over a CU table: each CU's residual
    read and samples written (int16) with its 2 (w + h) neighbours read,
    in every plane, about 12 operations a sample."""
    t = _host(icu).astype(np.int64)
    w, h = 1 << t[:, log2w], 1 << t[:, log2h]
    n = w * h * (1.5 if chroma else 1)
    nb = 2 * (w + h) * (2 if chroma else 1)
    return int((4 * n + 2 * nb).sum() + t.size * 4), int(12 * n.sum())


def deblock_work(kind, st):
    """(bytes, ops) of a Baseline deblock pass: per edge line with a
    strength, 4 samples read and 4 (luma) or 2 (chroma) written, about 20
    operations; the strength map read."""
    s = _host(st) > 0
    luma = kind.startswith("luma")
    on = (s[:, 1:] if kind.endswith("ver") else s[1:, :]).sum() * (
        4 if luma else 2)
    return int(on * (16 if luma else 12) + s.size * 4), int(on * 20)


def itdq_case(dev, bd, h, w, chroma=True, seed=0, coef_max=3000, iqt=False):
    """A frame's TU table over h x w coefficient planes; `iqt`: the Main
    transforms, with ATS bases on some luma TUs."""
    coefs, tus, shp_y, shp_c = itdq_frame(bd, h, w, chroma, seed, coef_max,
                                          main=iqt)
    tc = [_dev(c, dev) for c in coefs] + [None] * (3 - len(coefs))
    args = (tc, _dev(tus, dev), shp_y, shp_c, bd, device_tables(dev), iqt)
    nbytes, ops = itdq_work(tus)
    return KernelCase("itdq", f"{h}x{w} bd{bd}{' iqt+ATS' if iqt else ''}, "
                      f"{len(tus)} TUs",
                      lambda: TQ.itdq(*args), lambda: TQ.itdq_ref(*args),
                      nbytes, ops)


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
                      lambda: [TR.pad_ref(area, h, w, pad)],
                      2 * (h * w + (h + 2 * pad) * (w + 2 * pad)), 0)


def intra_planes_case(dev, recs, res, icu, bd, chroma, shape):
    """The intra scan on device planes `recs` (left untouched: each side
    scans a copy of its own) with residuals `res` and CU table `icu`."""
    a = [None if r is None else r.clone() for r in recs]
    b = [None if r is None else r.clone() for r in recs]
    return KernelCase(
        "intra_scan", shape,
        lambda: list(TI.intra_scan(a, res, icu, bd, chroma)),
        lambda: list(TI.intra_scan_ref(b, res, icu, bd, chroma)),
        *intra_work(icu, PK.CU_LOG2, PK.CU_LOG2, chroma))


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
                                             chroma)),
        *intra_work(icu, PK.ICM_LOG2W, PK.ICM_LOG2H, chroma))


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
                      kernel, plain, *deblock_work(kind, st))


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
                                   main_taps)),
        *mc_work(table))


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
                      lambda: [TR.recon_ref(resid, bd, pred, cnt)],
                      H * W * 9, H * W * 6)


# --------------------------------------------------------------------------
# SUCO chroma order (K10), ADDB (K11), ALF (K13)
# --------------------------------------------------------------------------
def suco_planes_case(dev, u, v, row_off, edges, bd, shape):
    """K10 on chroma areas u, v (views into device planes, left untouched:
    each side filters copies of its own) with the edge table row_off,
    edges (host or device)."""
    off, ed = (_dev(np.asarray(a), dev) if isinstance(a, np.ndarray) else a
               for a in (row_off, edges))
    a = (u.clone(), v.clone())
    b = (u.clone(), v.clone())
    n = int(ed.shape[0])
    return KernelCase(
        "chroma_ver_ordered", shape,
        lambda: list(TD.chroma_ver_ordered(*a, off, ed, bd)),
        lambda: (TD.chroma_ver_ordered_ref(*b, off, ed, bd), list(b))[1],
        bytes=n * 2 * 2 * 6 * 2 + (off.numel() + ed.numel()) * 4,
        ops=n * 2 * 2 * 14)


def suco_case(dev, bd, h_scu, w_scu, seed=0):
    """K10 on synthetic chroma planes with a random edge table."""
    rng = np.random.default_rng(seed + bd)
    u, v = (_dev(smooth_plane(rng, 2 * h_scu, 2 * w_scu, bd, 8), dev)
            for _ in range(2))
    row_off, edges = suco_edges(rng, h_scu, w_scu)
    return suco_planes_case(dev, u, v, row_off, edges, bd,
                            f"{2 * h_scu}x{2 * w_scu} bd{bd}, {len(edges)} "
                            "edges")


def _addb_work(kind, pars):
    """(bytes, ops) of an ADDB pass: per edge line with bs > 0, 8 samples
    read and 6 written (luma) or 4 and 2 (chroma), about 60 (25)
    operations; the 4 parameters of each map cell on the edge grid."""
    bs = _host(pars)[..., 0]
    grid = bs[:, 2::2] if kind.endswith("ver") else bs[2::2, :]
    luma = kind.startswith("luma")
    n = int((grid > 0).sum()) * (4 if luma else 2)
    return n * (28 if luma else 12) + grid.size * 16, n * (60 if luma else 25)


def _two_copies(area):
    """(a, b, view): two copies of the whole plane `area` is a view into,
    and view(copy), the same view into a copy -- so that a kernel and its
    plain version each filter a plane of their own in place, with the row
    pitch and border the main path gives them."""
    base = area
    while base._base is not None:
        base = base._base
    off, (H, W), stride = area.storage_offset(), area.shape, area.stride()
    return (base.clone(), base.clone(),
            lambda t: t.as_strided((H, W), stride, off))


def addb_planes_case(dev, kind, area, pars, bd, cb, shape):
    """One ADDB pass on `area` (a view into a device plane, left untouched)
    with `pars` [H/u, W/u, C] on the device."""
    a, b, view = _two_copies(area)
    return KernelCase(
        f"addb_{kind}", shape,
        lambda: (TA.addb_pass(kind, view(a), pars, bd, cb), [a])[1],
        lambda: (TA._REFS[kind](view(b), pars, bd, cb), [b])[1],
        *_addb_work(kind, pars))


def addb_case(dev, kind, bd, H, W, seed=0, cb=1):
    """One ADDB pass on a synthetic H x W area of a bordered plane, with a
    random parameter map (7 channels for chroma: U at cb 1, V at cb 4)."""
    rng = np.random.default_rng(seed + bd + len(kind))
    luma = kind.startswith("luma")
    u = 4 if luma else 2
    plane = bordered(rng, H, W, 0, 1 << bd)
    plane[BORDER:BORDER + H, BORDER:BORDER + W] = smooth_plane(rng, H, W, bd)
    d = _dev(plane, dev)
    pars = _dev(addb_pars(rng, H // u, W // u, bd, 4 if luma else 7)[0], dev)
    area = d[BORDER:BORDER + H, BORDER:BORDER + W]
    return addb_planes_case(dev, kind, area, pars, bd, cb,
                            f"{H}x{W} bd{bd}" + ("" if luma else f" cb{cb}"))


def alf_planes_case(dev, luma, area, coef, ctu_on, ph, pw, log2_s, bd,
                    across, shape):
    """ALF of one plane on `area` (a view into a device plane, left
    untouched)."""
    a, b, view = _two_copies(area)
    S = 1 << log2_s
    n_w, n_h = -(-pw // S), -(-ph // S)
    if luma:
        on = np.asarray(ctu_on.cpu()) > 0
        idx = np.arange(n_w * n_h)
        wb = np.minimum(S, pw - idx % n_w * S)
        hb = np.minimum(S, ph - idx // n_w * S)
        samples = int((wb * hb)[on].sum())
    else:
        samples = ph * pw
    return KernelCase(
        "alf_luma" if luma else "alf_chroma", shape,
        lambda: (TL.alf_plane(view(a), coef, ctu_on, ph, pw, log2_s, bd,
                              across, luma), [a])[1],
        lambda: (TL.alf_plane_ref(view(b), coef, ctu_on, ph, pw, log2_s, bd,
                                  across, luma), [b])[1],
        # a sample's operations, each counted once: luma four Laplacians
        # (4 each) and their sums (3 of 4 samples) 19, box sums and the
        # classification about 4, the 7x7 diamond (12 tap-pair adds, 13
        # multiply-adds, round, shift, clip) 41; chroma the 5x5 diamond 23
        bytes=ph * pw * 2 + samples * 2 + coef.numel() * 4,
        ops=samples * (64 if luma else 23))


def alf_case(dev, luma, bd, h, w, log2_ctu, across, seed=0):
    """ALF of one plane of an h x w picture (chroma: h/2 x w/2) on the
    SCU-rounded area of a bordered plane of random samples, random
    coefficients and CTU flags."""
    rng = np.random.default_rng(seed + bd + 2 * luma + across)
    ph, pw = (h, w) if luma else (h >> 1, w >> 1)
    log2_s = log2_ctu if luma else log2_ctu - 1
    plane = _dev(bordered(rng, ph + 8, pw + 8, 0, 1 << bd), dev)
    area = plane[BORDER:BORDER + ph + 4, BORDER:BORDER + pw + 4]
    cl, cc = alf_coefs(rng)
    S = 1 << log2_ctu
    n_ctu = -(-h // S) * -(-w // S)
    ctu_on = _dev((rng.random(n_ctu) < 0.7).astype(np.int32), dev)
    return alf_planes_case(
        dev, luma, area, _dev(cl if luma else cc, dev), ctu_on, ph, pw,
        log2_s, bd, across,
        f"{'luma' if luma else 'chroma'} {pw}x{ph} CTU {1 << log2_s} bd{bd}"
        f" across {int(across)}")


def frame_areas_before(pf, dev, stage):
    """(areas, df): a packed frame's deblock/ALF areas on `dev` just before
    `stage` ("deblock" or "alf"), run through the main path's own stage
    functions (ops/pipeline.py)."""
    from xevd_tpu_torch.ops import pipeline as PP
    tables = device_tables(dev)
    df = PK.upload(pf, dev)
    resids, recs = PP.residuals_and_recon(df, tables)
    PP.intra_stage(df, recs, resids, tables)
    areas = PP.frame_areas(df, recs)
    if stage == "alf":
        PP.deblock_stage(df, areas)
    return areas, df
