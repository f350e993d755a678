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

# the oracle's process (torch_reference.py) loads no torch: its helper
# lives there, and the tests take it from here
from tests.torch_reference import use_port_native_library  # noqa: F401


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


def _scene_planes(rng, H, W, bd):
    """Random bordered picture planes and residuals (y, u, v) of an H x W
    picture; one residual wraps pred + resid through int16."""
    maxv = (1 << bd) - 1
    recs = [bordered(rng, H, W, 0, maxv + 1)]
    recs += [bordered(rng, H // 2, W // 2, 0, maxv + 1) for _ in range(2)]
    res = [bordered(rng, H, W, -600, 600)]
    res += [bordered(rng, H // 2, W // 2, -600, 600) for _ in range(2)]
    res[0][BORDER, BORDER] = 32767     # int16 wrap of pred + resid
    return recs, res


def _i32(v):
    """A uint32 bitfield as the int32 the CU table carries."""
    return v - (1 << 32) if v >= 1 << 31 else v


def _causal(rows, H, W):
    """The CU rows with every up/left mask bit and corner flag cleared
    whose 4x4 cell no earlier row covers, as a decoder sets them: the rows
    a scan that follows dependencies must give in decode order."""
    hs, ws = H >> 2, W >> 2
    done = np.zeros((hs, ws), bool)

    def cell(cy, cx):
        return 0 <= cy < hs and 0 <= cx < ws and bool(done[cy, cx])

    out = []
    for x, y, lg, ipm, up, left, cor, valid in rows:
        xs, ys, s = x >> 2, y >> 2, 1 << (lg - 2)
        up_c = sum(1 << u for u in range(2 * s) if cell(ys - 1, xs + u))
        le_c = sum(1 << u for u in range(2 * s) if cell(ys + u, xs - 1))
        out.append((x, y, lg, ipm, _i32(up & up_c), _i32(left & le_c),
                    cor & int(cell(ys - 1, xs - 1)), valid))
        done[ys:ys + s, xs:xs + s] = True
    return out


def intra_scene(H, W, bd, seed, causal=False):
    """Random bordered planes, residuals and a z-order CU table (x, y,
    log2, ipm, up_mask, left_mask, corner, valid) covering the picture.
    The masks are random bits; `causal` keeps only those whose cell an
    earlier CU covers, as a decoder's are (`_causal`)."""
    rng = np.random.default_rng(seed)
    recs, res = _scene_planes(rng, H, W, bd)
    rows = []
    for y, x, lg in quadtree(rng, H, W, 6, 3):
        rows.append((x, y, lg, int(rng.integers(0, 5)),
                     int(rng.integers(-2 ** 31, 2 ** 31)),
                     int(rng.integers(-2 ** 31, 2 ** 31)),
                     int(rng.integers(0, 2)), int(rng.random() > 0.05)))
    if causal:
        rows = _causal(rows, H, W)
    return recs, res, np.array(rows, np.int32)


def intra_chain_scene(H, W, bd, seed):
    """The worst case of a dependency-driven intra scan: an H x W picture
    (multiples of 64) of 4x4 CUs in z-order, every mask bit and corner
    flag set where an earlier CU covers the cell."""
    rng = np.random.default_rng(seed)
    recs, res = _scene_planes(rng, H, W, bd)
    rows = []

    def zorder(y, x, log2):
        if log2 == 2:
            rows.append((x, y, 2, int(rng.integers(0, 5)), -1, -1, 1, 1))
            return
        h = 1 << (log2 - 1)
        for dy, dx in ((0, 0), (0, h), (h, 0), (h, h)):
            zorder(y + dy, x + dx, log2 - 1)
    for y in range(0, H, 64):
        for x in range(0, W, 64):
            zorder(y, x, 6)
    return recs, res, np.array(_causal(rows, H, W), np.int32)


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
    HTDF-only inter CUs and HTDF on a share of the CUs that are not
    TREE_C.  Neighbour masks,
    left/right availability and the HTDF ring bits are set where the cell
    was written by an earlier CU, as a decoder sets them; the levels come
    from `xevd_tpu_torch.host.ops.wavefront.level_scan_cus`.  Returns (recs, res,
    table, level_off) as `pack_intra_main` would (numpy)."""
    from types import SimpleNamespace

    from xevd_tpu_torch.host.ops.wavefront import level_scan_cus

    rng = np.random.default_rng(seed)
    recs, res = _scene_planes(rng, H, W, bd)
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
        if tree == 2:       # luma-only filter: never on a TREE_C CU
            hidx = -1       # (host/derive.py:396), nor in the level rule
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
            # the frame views a staging slot that later frames rewrite
            pf = super().pack_frame(job, sps, refp)
            self.frames.append((job, sps, refp, pf.copy()))
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


CHROMA_MAPS = ("random", "all", "zero")


def chroma_map(rng, kind, h_scu, w_scu):
    """A strength map [h_scu, w_scu] of one kind: "random" (`strengths`:
    short runs), "all" (every edge a strength in 1..12: each line one run,
    the longest chains of K9) or "zero" (no edge)."""
    if kind == "random":
        return strengths(rng, h_scu, w_scu)[0]
    if kind == "all":
        return rng.integers(1, 13, size=(h_scu, w_scu)).astype(np.int32)
    if kind == "zero":
        return np.zeros((h_scu, w_scu), np.int32)
    raise ValueError(kind)


def run_lengths(st, kind):
    """The lengths of K9's runs in a chroma strength map (int [h_scu,
    w_scu]): consecutive edges with a strength along an SCU row
    ("chroma_ver") or column ("chroma_hor"); edge 0 is the area's side."""
    on = np.asarray(st) > 0
    on = (on if kind == "chroma_ver" else on.T)[:, 1:]
    pad = np.zeros((on.shape[0], 1), bool)
    d = np.diff(np.concatenate([pad, on, pad], 1).astype(np.int8), axis=1)
    starts, ends = np.nonzero(d == 1), np.nonzero(d == -1)
    return ends[1] - starts[1]


LUMA_MAPS = ("random", "all", "zero", "ver", "hor")


def luma_maps(rng, kind, h_scu, w_scu):
    """The luma strength maps (st_ver, st_hor), int32 [h_scu, w_scu] each,
    of one kind: "random" (`strengths` both), "all" (every edge the largest
    strength, 12), "zero" (no edge), "ver" / "hor" (a random map in that
    direction, no edge in the other)."""
    def rand():
        return strengths(rng, h_scu, w_scu)[0]
    zero = np.zeros((h_scu, w_scu), np.int32)
    if kind == "random":
        return rand(), rand()
    if kind == "all":
        return np.full_like(zero, 12), np.full_like(zero, 12)
    if kind == "zero":
        return zero, zero.copy()
    if kind == "ver":
        return rand(), zero
    if kind == "hor":
        return zero, rand()
    raise ValueError(kind)


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


SUCO_LISTS = ("random", "all", "long", "repeat", "empty")


def suco_lists(rng, kind, h_scu, w_scu):
    """A SUCO chroma edge table (row_off, edges) as `suco_edges` of one
    kind: "random" (`suco_edges`: short runs, repeats, neighbours with
    mixed U and V strengths), "all" (every column of every row in both
    planes, each row's columns in a random order: each row one run a plane
    of w_scu - 1 columns), "long" (the first row's columns left to right
    and back again in U only, a run of 2 w_scu - 3 entries; the other rows
    random), "repeat" (a few columns a row, each listed two to four times
    in a random order, with mixed strengths) or "empty" (one row in seven
    has edges, the rest none)."""
    if kind == "random":
        return suco_edges(rng, h_scu, w_scu)
    rows = []
    for r in range(h_scu):
        cols = []
        if kind == "all":
            cols = list(rng.permutation(np.arange(1, w_scu)))
        elif kind == "long" and r == 0:
            cols = list(range(1, w_scu)) + list(range(w_scu - 2, 0, -1))
        elif kind == "repeat":
            cols = [c for c in rng.choice(np.arange(1, w_scu), 4,
                                          replace=False)
                    for _ in range(int(rng.integers(2, 5)))]
            cols = list(rng.permutation(cols))
        elif kind == "empty" and r % 7 == 3:
            cols = list(rng.integers(1, w_scu, size=6))
        elif kind in ("long", "empty"):
            cols = [] if kind == "empty" else list(
                rng.integers(1, w_scu, size=int(rng.integers(0, 6))))
        ed = []
        for c in cols:
            su, sv = (int(x) for x in rng.integers(1, 13, size=2))
            if kind == "long":
                sv = 0
            elif kind in ("repeat", "empty"):
                su, sv = (s * int(rng.random() < 0.7) for s in (su, sv))
                if su == sv == 0:
                    su = 3
            ed.append((2 * int(c), su, sv))
        rows.append(ed)
    row_off = np.concatenate([[0], np.cumsum([len(e) for e in rows])])
    edges = np.asarray([e for ed in rows for e in ed], np.int32)
    return row_off.astype(np.int32), edges.reshape(-1, 3)


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
    reset: Callable | None = None   # restore the inputs (no-op if none
    #                                 change): repeated launches compare
    copy_bytes: int = 0       # bytes the design moves beyond the function's
    graph_calls: int = 20     # > 1: also timed a call in graphs of this many
    #                           calls (a one-call graph lasts at least the
    #                           host's launch of the graph, some 5 us); 1
    #                           for the persistent scans, whose ticket state
    #                           is per launch, and K15's whole step


def max_abs_err(got, want) -> int:
    """Largest |got - want| over two equal-length sequences of tensors
    (None where a plane is absent, e.g. 4:0:0 chroma), `want` brought to
    `got`'s device (a plain version run on the CPU)."""
    err = 0
    for g, w in zip(got, want, strict=True):
        if (g is None) != (w is None):
            raise AssertionError("one side has a plane the other lacks")
        if g is None:
            continue
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        err = max(err, int((g.to(torch.int64) - w.to(g.device, torch.int64))
                           .abs().max().item()))
    return err


def compare(case: KernelCase) -> int:
    """Runs the kernel and the plain version once each; max abs error."""
    got = case.kernel()
    want = case.plain()
    torch.cuda.synchronize()
    return max_abs_err(got, want)


def repeat_equal(case: KernelCase, want, launches: int) -> int:
    """Race check: `launches` runs, each from the case's inputs
    (`case.reset` before it) and each compared with `want`, the plain
    version's one result; the largest error over them.  A race between
    CTAs or threads shows as a difference between runs, not as a constant
    error."""
    err = 0
    for _ in range(launches):
        case.reset()
        err = max(err, max_abs_err(case.kernel(), want))
    return err


def _copies(planes):
    """(a, b, reset): two copies of the device planes (None kept) for a
    kernel and its plain version to update in place, and a function that
    restores the kernel's copy."""
    a = [None if r is None else r.clone() for r in planes]
    b = [None if r is None else r.clone() for r in planes]
    src = [None if r is None else r.clone() for r in planes]

    def reset():
        for x, r in zip(a, src):
            if x is not None:
                x.copy_(r)
    return a, b, reset


def _to(x, dev):
    return None if x is None else x.to(dev)


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
    on = (s[..., 1:] if kind.endswith("ver") else s[..., 1:, :]).sum() * (
        4 if luma else 2)
    return int(on * (16 if luma else 12) + s.size * 4), int(on * 20)


def deblock_luma_work(st_ver, st_hor):
    """(bytes, ops) of K8's fused luma deblock (ver then hor) on maps
    [..., h_scu, w_scu] (either None): each sample that an edge with a
    strength reaches read and written once (int16) -- a shifted block's
    rows with a vertical strength and its columns with a horizontal one,
    counted once where they cross -- both maps read; about 20 operations
    an edge line."""
    m = [None if s is None else _host(s) for s in (st_ver, st_hor)]
    shape = next(x.shape for x in m if x is not None)
    v, h = (np.zeros(shape, bool) if x is None else x > 0 for x in m)
    v, h = v.copy(), h.copy()
    v[..., 0] = False                       # x = 0, y = 0: the area's sides
    h[..., 0, :] = False
    hs, ws = shape[-2:]
    # per shifted block (f, e): rows with a ver edge (of 4, by pairs) and
    # columns with a hor edge
    rows = np.zeros(shape[:-2] + (hs + 1, ws + 1, 2), np.int64)
    cols = np.zeros_like(rows)
    rows[..., 1:, :ws, 0] = v                # SCU row f - 1: rows 0, 1
    rows[..., :hs, :ws, 1] = v               # SCU row f: rows 2, 3
    cols[..., :hs, 1:, 0] = h                # SCU column e - 1: cols 0, 1
    cols[..., :hs, :ws, 1] = h               # SCU column e: cols 2, 3
    nr, nc = 2 * rows.sum(-1), 2 * cols.sum(-1)
    samples = int((4 * nr + 4 * nc - nr * nc).sum())
    lines = int(v.sum() + h.sum()) * 4
    return (samples * 4 + sum(x.size * 4 for x in m if x is not None),
            lines * 20)


def itdq_order_on(dev, tus, iqt, tu_off=None):
    """The ITDQ kernel's class order (ops/pack.py `itdq_order`) of a host
    TU table, its tables on `dev`, as the pack uploads it."""
    frame = None
    if tu_off is not None:
        frame = np.repeat(np.arange(len(tu_off) - 1), np.diff(tu_off))
    o = PK.itdq_order(np.asarray(tus), iqt, frame)
    return PK.ItdqOrder(_dev(o.order, dev), _dev(o.classes, dev), o.n_cta,
                        o.smem)


def mc_order_on(dev, table, lists, mc_off=None):
    """The MC kernel's class order (ops/pack.py `mc_order`) of a host or
    device block table, its tables on `dev`, as the pack uploads it; with
    `mc_off` (a GOP batch) each row's frame g from the offsets."""
    frame = None
    if mc_off is not None:
        off = _host(mc_off)
        frame = np.concatenate([np.repeat(np.arange(off.shape[1] - 1),
                                          np.diff(o)) for o in off])
    o = PK.mc_order(_host(table), lists, frame)
    return PK.McOrder(_dev(o.order, dev), _dev(o.classes, dev), o.lists)


def mc_class_histogram(order: PK.McOrder):
    """{class label: blocks} of an McOrder, both lists summed; a label is
    plane (l or c), w x h and case (00, N0, 0N, NN)."""
    hist = {}
    for _, _, count, shape in _host(order.classes):
        key = (f"{'lc'[shape >> 13 & 1]}{1 << ((shape >> 5) & 7)}x"
               f"{1 << ((shape >> 2) & 7)}"
               f"{('00', 'N0', '0N', 'NN')[shape & 3]}")
        hist[key] = hist.get(key, 0) + int(count)
    return hist


def mc_class_frame(bd, seed=0, n=2):
    """An MC block table with every class of the MC kernel: n blocks of
    each plane group (luma 4..64, chroma 2..32 a side, square and
    rectangular) and filter case, in both lists over the same cells (cnt
    reaches 2); windows anywhere in their reference planes, a share of
    them at the planes' edges (as clipped MVs give) and a quarter of the
    filtering ones at phase 0; two reference slots, the second over the
    whole int16 range (NN's intermediate wraps).  Returns (table, lists,
    refs: per slot host (y, u, v) int16 planes, shp_y, shp_c)."""
    rng = np.random.default_rng(seed + bd)
    ref_hw = ((160, 256), (96, 160))                 # luma, chroma
    refs = []
    for slot in range(2):
        lo, hi = (0, 1 << bd) if slot == 0 else (-32768, 32768)
        y = rng.integers(lo, hi, size=ref_hw[0])
        u = rng.integers(lo, hi, size=ref_hw[1])
        refs.append(tuple(np.ascontiguousarray(p, np.int16)
                          for p in (y, u, u[::-1])))
    rows, shapes = [], []
    for plane, width in ((0, 512), (1, 256)):
        fbits, half, ntap = (4, 3, 8) if plane == 0 else (5, 1, 4)
        lmin = 2 - plane
        specs = [(1 << lw, 1 << lh, case)
                 for lw in range(lmin, lmin + 5)
                 for lh in range(lmin, lmin + 5) for case in range(4)
                 for _ in range(n)]
        specs.sort(key=lambda s: -s[1])
        pos, height = _shelves([(h, w) for w, h, _ in specs], width)
        shapes.append((BORDER + height + PAD_R, BORDER + width + PAD_R))
        H, W = ref_hw[plane]
        for lidx in (0, 1):
            for (y, x), (w, h, case) in zip(pos, specs):
                g = []
                for size, extent, taps in ((w, W, case & 1),
                                           (h, H, case & 2)):
                    span = size + (ntap - 1 if taps else 0)
                    lo = int(rng.integers(0, extent - span + 1))
                    edge = rng.random()
                    lo = 0 if edge < 0.15 else (extent - span if edge > 0.85
                                                else lo)
                    f = int(rng.integers(0, 1 << fbits)) if taps else 0
                    f = 0 if rng.random() < 0.25 else f
                    g.append(((lo + (half if taps else 0)) << fbits) + f)
                rows.append((lidx, plane, w, h, case, int(rng.integers(0, 2)),
                             g[0], g[1], BORDER + y, BORDER + x, lidx))
    rows.sort(key=lambda r: r[0])                   # list 0's rows first
    table = np.array([r[1:] for r in rows], np.int32)
    n0 = int((table[:, PK.MC_LIST] == 0).sum())
    return table, (n0, len(table) - n0), refs, shapes[0], shapes[1]


def mc_class_case(dev, bd, main_taps=False, seed=0, n=2):
    """The MC kernel against its plain version on `mc_class_frame`: every
    class in each list's launch (`reset` a no-op: each launch writes new
    planes)."""
    table, lists, refs, shp_y, shp_c = mc_class_frame(bd, seed, n)
    drefs = [tuple(_dev(p, dev) for p in r) for r in refs]
    return mc_table_case(
        dev, table, lists, drefs, shp_y, shp_c, bd,
        f"every class, {lists[0]}+{lists[1]} blocks bd{bd}"
        f"{' Main taps' if main_taps else ''}", main_taps)


def itdq_case(dev, bd, h, w, chroma=True, seed=0, coef_max=3000, iqt=False):
    """A frame's TU table over h x w coefficient planes; `iqt`: the Main
    transforms, with ATS bases on some luma TUs."""
    coefs, tus, shp_y, shp_c = itdq_frame(bd, h, w, chroma, seed, coef_max,
                                          main=iqt)
    tc = [_dev(c, dev) for c in coefs] + [None] * (3 - len(coefs))
    args = (tc, _dev(tus, dev), shp_y, shp_c, bd, device_tables(dev), iqt)
    order = itdq_order_on(dev, tus, iqt)
    nbytes, ops = itdq_work(tus)
    return KernelCase("itdq", f"{h}x{w} bd{bd}{' iqt+ATS' if iqt else ''}, "
                      f"{len(tus)} TUs",
                      lambda: TQ.itdq(*args, order=order),
                      lambda: TQ.itdq_ref(*args), nbytes, ops,
                      reset=lambda: None)


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
    order = itdq_order_on(dev, tus, iqt)
    kind = f" trs {trs}" if trs else (" iqt" if iqt else "")
    return KernelCase("itdq", f"{s}x{s} bd{bd}{kind}, {n} TUs",
                      lambda: TQ.itdq(*args, order=order),
                      lambda: TQ.itdq_ref(*args), reset=lambda: None)


def _shelves(sizes, width):
    """(y, x) of each (h, w) block packed left to right in rows of
    `width`, a new row below the tallest of the last; and the height."""
    pos, x, y, row_h = [], 0, 0, 0
    for h, w in sizes:
        if x + w > width:
            x, y, row_h = 0, y + row_h, 0
        pos.append((y, x))
        x += w
        row_h = max(row_h, h)
    return pos, y + row_h


def _worst_block(tables, lw, lh, trs):
    """Coefficients whose dequantized block at full scale is +-32767 with
    the signs of the height basis' column of largest absolute sum: stage 0
    reaches the int32 bound the kernel's widths rest on (one column y0
    sums |TMh[v][y0]| x 32767 in every column u)."""
    kind = (trs & 3) - 1 if trs else -1
    tm = TQ.basis(tables, lh, kind).numpy()       # [v, y]
    y0 = int(np.abs(tm).sum(0).argmax())
    sign = np.where(tm[:, y0] < 0, -1, 1)[:, None]
    return np.broadcast_to(sign * 32767, (1 << lh, 1 << lw))


# trs codes whose two fields each name a basis (0 DCT-2, 1 DST-7, 2 DCT-8);
# a stream carries 5, 6, 9 and 10 (ops/pack.py `_ats_trs`)
TRS_CODES = (1, 2, 4, 5, 6, 8, 9, 10)


def itdq_class_frame(bd, iqt, seed=0, extreme=False, n=3,
                     trs_codes=TRS_CODES):
    """A luma coefficient plane (int16) and TU table with every size class
    of the ITDQ kernel: n TUs of each (log2 w, log2 h) in 1..6 (2x2 to
    64x64, square and rectangular); and the bordered plane shape.  `iqt`
    False: Baseline TUs, and the `trs_codes` (Main classes) on TUs up to
    32 a side; `iqt` True: every TU Main (iqt DCT-2, and the trs codes up
    to 32).  `extreme`: every TU at the largest scale of the bit depth,
    coefficients over the whole int16 range, half the TUs built to reach
    stage 0's int32 bound."""
    rng = np.random.default_rng(seed + bd + 2 * iqt + 4 * extreme)
    qp_max = 51 + 6 * (bd - 8)
    scale_max = max(qp_scale(q, iqt) for q in range(qp_max + 1))
    tab = device_tables("cpu")
    specs = []
    for lw in range(1, 7):
        for lh in range(1, 7):
            for k in range(n):
                trs = (trs_codes[(k + lw + lh) % len(trs_codes)]
                       if max(lw, lh) <= 5 and (iqt or k % 2) else 0)
                specs.append((lw, lh, trs))
    order = sorted(range(len(specs)), key=lambda i: -specs[i][1])
    pos, height = _shelves([(1 << specs[i][1], 1 << specs[i][0])
                            for i in order], 512)
    coef = np.zeros((height, 512), np.int64)
    rows = []
    for (y, x), i in zip(pos, order):
        lw, lh, trs = specs[i]
        h, w = 1 << lh, 1 << lw
        if extreme:
            scale = scale_max
            blk = (_worst_block(tab, lw, lh, trs) if i % 2
                   else rng.integers(-32768, 32768, size=(h, w)))
        else:
            scale = qp_scale(int(rng.integers(0, qp_max + 1)), bool(
                iqt or trs))
            blk = rng.integers(-3000, 3000, size=(h, w))
        coef[y:y + h, x:x + w] = blk
        rows.append((0, lw, lh, scale, y, x, trs))
    shp = (BORDER + height + PAD_R, BORDER + 512 + PAD_R)
    return coef.astype(np.int16), np.array(rows, np.int32), shp


def itdq_class_case(dev, bd, iqt, seed=0, extreme=False, n=3):
    """The kernel against its plain version on `itdq_class_frame`, every
    size class in one launch (`reset` a no-op: each launch writes new
    planes)."""
    coef, tus, shp = itdq_class_frame(bd, iqt, seed, extreme, n)
    args = ([_dev(coef, dev), None, None], _dev(tus, dev), shp, None, bd,
            device_tables(dev), iqt)
    order = itdq_order_on(dev, tus, iqt)
    nbytes, ops = itdq_work(tus)
    return KernelCase(
        "itdq", f"{len(tus)} TUs of 36 sizes bd{bd} "
        f"{'iqt' if iqt else 'Baseline+ATS'}"
        f"{', full range at the largest scale' if extreme else ''}",
        lambda: TQ.itdq(*args, order=order), lambda: TQ.itdq_ref(*args),
        nbytes, ops, reset=lambda: None)


def recon_case(dev, bd, H, W, seed=0):
    resid = _dev(recon_planes(bd, H, W, seed)[0], dev)
    return KernelCase("recon", f"{H}x{W} bd{bd}",
                      lambda: [TR.recon(resid, bd)],
                      lambda: [TR.recon_ref(resid, bd)])


def pad_work(G, h, w, chroma):
    """Bytes of K14 on G pictures: each plane's h x w crop read once and
    its padded plane written once (int16)."""
    n = h * w + (h + 2 * PAD_L) * (w + 2 * PAD_L)
    if chroma:
        n += 2 * ((h >> 1) * (w >> 1)
                  + ((h >> 1) + 2 * PAD_C) * ((w >> 1) + 2 * PAD_C))
    return 2 * G * n


def pad_areas_case(dev, areas, h, w, chroma, shape, out=None):
    """K14 on one picture's areas (y, u, v views into device planes; [G,
    ...] for a GOP batch step), as the path calls it: `pad_picture`, one
    launch, into new planes or the planes of `out` (each side writes
    copies of its own), against `pad_ref` plane by plane."""
    mine = None if out is None else [None if o is None else o.clone()
                                     for o in out]
    G = areas[0].shape[0] if areas[0].dim() == 3 else 1
    crops = [(h, w, PAD_L)] + [(h >> 1, w >> 1, PAD_C)] * 2

    def plain():
        return [TR.pad_ref(a, *c) for a, c in zip(areas, crops)
                if a is not None]
    return KernelCase(
        "pad", shape,
        lambda: [p for p in TR.pad_picture(*areas, h, w, chroma, out=mine)
                 if p is not None],
        plain, pad_work(G, h, w, chroma), 0, reset=lambda: None)


def picture_areas(dev, bd, h, w, chroma=True, G=None, unaligned=False,
                  seed=0):
    """The (y, u, v) SCU areas of a synthetic h x w picture (or of G, a
    GOP batch step: [G, H, W]) as the path gives them: views into
    bordered planes of random samples (a row pitch, the area 8-px
    rounded); u, v None for 4:0:0; `unaligned` gives every plane an odd
    row pitch."""
    rng = np.random.default_rng(seed + bd + 2 * chroma + (G or 0))
    H8, W8 = -(-h // 8) * 8, -(-w // 8) * 8
    extra = 1 if unaligned else 0
    areas = []
    for k, (ph, pw) in enumerate(((H8, W8), (H8 >> 1, W8 >> 1),
                                  (H8 >> 1, W8 >> 1))):
        if k and not chroma:
            areas.append(None)
            continue
        p = np.stack([bordered(rng, ph, pw + extra, 0, 1 << bd)
                      for _ in range(G or 1)])
        t = _dev(p if G else p[0], dev)
        areas.append(t[..., BORDER:BORDER + ph, BORDER:BORDER + pw])
    return areas


def pad_picture_case(dev, bd, h, w, chroma=True, G=None, unaligned=False,
                     seed=0):
    """K14 on a synthetic picture, or G of them (`picture_areas`);
    `unaligned`: odd row pitches (scalar loads)."""
    return pad_areas_case(
        dev, picture_areas(dev, bd, h, w, chroma, G, unaligned, seed), h, w,
        chroma,
        f"{f'G {G} x ' if G else ''}{w}x{h} {'4:2:0' if chroma else '4:0:0'}"
        f" bd{bd}{' unaligned pitch' if unaligned else ''}")


def intra_planes_case(dev, recs, res, icu, bd, chroma, shape, icu_off=None,
                      order=None, plain_device=None):
    """The intra scan on device planes `recs` (left untouched: each side
    scans a copy of its own) with residuals `res` and CU table `icu`; a
    GOP batch with `icu_off` and the ticket order `order` (the kernel's
    walk), held to the frame-after-frame plain version (on copies of its
    inputs on `plain_device` where given: the CPU walks CUs faster than a
    launch a tensor operation)."""
    a, b, reset = _copies(recs)

    def plain():
        if plain_device is None:
            pb, pr, pi, po = b, res, icu, icu_off
        else:
            pb, pr = ([None if x is None else x.to(plain_device) for x in xs]
                      for xs in (b, res))
            pi, po = icu.to(plain_device), _to(icu_off, plain_device)
        if icu_off is None:
            return list(TI.intra_scan_ref(pb, pr, pi, bd, chroma))
        return list(TI.intra_scan_batch_ref(pb, pr, pi, po, bd, chroma))
    return KernelCase(
        "intra_scan", shape,
        lambda: list(TI.intra_scan(a, res, icu, bd, chroma, icu_off=icu_off,
                                   order=order)),
        plain, *intra_work(icu, PK.CU_LOG2, PK.CU_LOG2, chroma), reset=reset,
        graph_calls=1)


def intra_case(dev, H, W, bd, chroma=True, seed=0):
    """A random z-order CU list with random causal neighbour masks over
    H x W."""
    recs, res, icu = intra_scene(H, W, bd, seed, causal=True)
    return intra_planes_case(
        dev, [_dev(p, dev) for p in recs], [_dev(p, dev) for p in res],
        _dev(icu, dev), bd, chroma,
        f"{H}x{W} bd{bd}{'' if chroma else ' luma'}, {len(icu)} CUs")


def intra_chain_case(dev, H, W, bd, seed=0):
    """4x4 CUs with every causal bit set (`intra_chain_scene`)."""
    recs, res, icu = intra_chain_scene(H, W, bd, seed)
    return intra_planes_case(
        dev, [_dev(p, dev) for p in recs], [_dev(p, dev) for p in res],
        _dev(icu, dev), bd, True,
        f"{H}x{W} bd{bd} 4x4 chain, {len(icu)} CUs, depth "
        f"{TI.intra_dag_depth(icu, H >> 2, W >> 2)}")


def intra_batch_scenes(G, H, W, bd, seed=0):
    """G causal scenes (`intra_scene`) of H x W as a GOP batch of the scan,
    numpy: planes [G, ...] (y, u, v), residuals, the tables one after
    another, their row offsets and the pack's ticket order (ops/pack.py
    `icu_order`)."""
    scenes = [intra_scene(H, W, bd, seed + g, causal=True) for g in range(G)]
    counts = [len(sc[2]) for sc in scenes]
    return ([np.stack([sc[0][i] for sc in scenes]) for i in range(3)],
            [np.stack([sc[1][i] for sc in scenes]) for i in range(3)],
            np.concatenate([sc[2] for sc in scenes]),
            np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
            PK.icu_order([sc[2] for sc in scenes], H >> 2, W >> 2))


def intra_batch_case(dev, G, H, W, bd, seed=0):
    """The batched scan over G causal scenes (`intra_batch_scenes`) of H x
    W in the pack's ticket order."""
    recs, res, icu, off, order = intra_batch_scenes(G, H, W, bd, seed)
    return intra_planes_case(
        dev, [_dev(p, dev) for p in recs], [_dev(p, dev) for p in res],
        _dev(icu, dev), bd, True,
        f"G {G} x {H}x{W} bd{bd}, {len(icu)} CUs",
        icu_off=_dev(off, dev), order=_dev(order, dev))


def intra_wave_planes_case(dev, recs, res, icu, level_off, bd, chroma,
                           shape):
    """The EIPD wavefront scan on device planes `recs` (left untouched:
    each side scans a copy of its own) with residuals `res`, CU table
    `icu` and level offsets `level_off` on the device."""
    tab = device_tables(dev)
    a, b, reset = _copies(recs)
    return KernelCase(
        "intra_scan_wave", shape,
        lambda: list(TIM.intra_scan_wave(a, res, icu, level_off, bd, chroma,
                                         tab)),
        lambda: list(TIM.intra_scan_wave_ref(b, res, icu, level_off, bd,
                                             chroma)),
        *intra_work(icu, PK.ICM_LOG2W, PK.ICM_LOG2H, chroma), reset=reset,
        graph_calls=1)


def intra_wave_case(dev, H, W, bd, chroma=True, seed=0, htdf=True):
    """A synthetic EIPD frame (`eipd_scene`) over H x W."""
    recs, res, icu, level_off, _, _ = eipd_scene(H, W, bd, seed, chroma,
                                                  htdf)
    return intra_wave_planes_case(
        dev, [_dev(p, dev) for p in recs], [_dev(p, dev) for p in res],
        _dev(icu, dev), _dev(level_off, dev), bd, chroma,
        f"{H}x{W} bd{bd}{'' if chroma else ' luma'}"
        f"{' htdf' if htdf else ''}, {len(icu)} CUs, "
        f"{len(level_off) - 1} levels")


def _deblock_name(kind):
    """The launch counter of a Baseline deblock pass: a luma pass launches
    the fused luma kernel (with the other map absent)."""
    return "deblock_luma" if kind.startswith("luma") else f"deblock_{kind}"


def deblock_case(dev, kind, bd, h_scu, w_scu, seed=0, st=None, label=""):
    """One pass in place on the SCU-area view of a bordered plane (as the
    pipeline calls it); each side filters a plane of its own, and `reset`
    restores the kernel's.  `st`: the strength map (numpy [h_scu, w_scu];
    random, `strengths`, by default)."""
    rng = np.random.default_rng(seed + bd + len(kind))
    u = 4 if kind.startswith("luma") else 2
    base = bordered(rng, h_scu * u, w_scu * u, 0, 1 << bd)
    st = _dev(strengths(rng, h_scu, w_scu)[0] if st is None else st, dev)
    a, b, src = _dev(base, dev), _dev(base, dev), _dev(base, dev)
    sl = (slice(BORDER, BORDER + h_scu * u), slice(BORDER, BORDER + w_scu * u))

    def kernel():
        TD.deblock_pass(kind, a[sl], st, bd)
        return [a]

    def plain():
        TD._REFS[kind](b[sl], st, bd)
        return [b]
    return KernelCase(_deblock_name(kind),
                      f"{h_scu * u}x{w_scu * u} bd{bd} {kind}{label}", kernel,
                      plain, *deblock_work(kind, st),
                      reset=lambda: a.copy_(src))


def deblock_area_case(dev, kind, area, st, bd, shape):
    """One pass on a copy of a frame's own area (SCU-cropped view of its
    plane, as the path hands it) with its own strength map."""
    a, b, src = area.clone(), area.clone(), area.clone()

    def kernel():
        TD.deblock_pass(kind, a, st, bd)
        return [a]

    def plain():
        TD._REFS[kind](b, st, bd)
        return [b]
    return KernelCase(_deblock_name(kind), shape, kernel, plain,
                      *deblock_work(kind, st), reset=lambda: a.copy_(src))


def deblock_luma_area_case(dev, area, st_ver, st_hor, bd, shape):
    """K8, both luma passes in one launch (`deblock_luma`), on copies of
    the plane (or GOP batch of planes) that `area` views, through the same
    view -- the row pitch and border the path gives the kernel -- with the
    maps st_ver, st_hor (either None: one pass); the plain version is
    `luma_blocks_ref` in raster order."""
    x, y, view = _two_copies(area)
    src = x.clone()

    def kernel():
        TD.deblock_luma(view(x), st_ver, st_hor, bd)
        return [x]

    def plain():
        TD.luma_blocks_ref(view(y), st_ver, st_hor, bd)
        return [y]
    return KernelCase("deblock_luma", shape, kernel, plain,
                      *deblock_luma_work(st_ver, st_hor),
                      reset=lambda: x.copy_(src))


def deblock_luma_case(dev, bd, h_scu, w_scu, seed=0, maps="random", G=None):
    """K8 on the SCU-area view of bordered planes with smooth samples (the
    filters decide both ways), one picture or a GOP batch of G, with maps
    of a kind (`luma_maps`, each picture its own)."""
    rng = np.random.default_rng(seed + bd + len(maps))
    H, W = 4 * h_scu, 4 * w_scu
    n = G or 1
    planes = _dev(np.stack([_padded(rng, H, W, bd) for _ in range(n)]), dev)
    st_ver, st_hor = (_dev(np.stack(m), dev) for m in zip(
        *(luma_maps(rng, maps, h_scu, w_scu) for _ in range(n))))
    area = planes[:, BORDER:BORDER + H, BORDER:BORDER + W]
    if G is None:
        area, st_ver, st_hor = area[0], st_ver[0], st_hor[0]
    return deblock_luma_area_case(
        dev, area, st_ver, st_hor, bd,
        f"{f'G {G} x ' if G else ''}{H}x{W} bd{bd} {maps} maps")


def mc_case(dev, H, W, bd, chroma=True, seed=0):
    """MC of a synthetic inter frame (`mc_frame`), packed by ops/pack.py,
    with every case, both lists and the identical-motion skip."""
    fs, job, refp = mc_frame(H, W, bd, chroma, seed, dev)
    table, lists, refs = PK.pack_mc(fs, job, refp, chroma)
    return mc_table_case(dev, table, lists, refs, *mc_shapes(fs, chroma), bd,
                         f"{H}x{W} bd{bd}{'' if chroma else ' luma'}, "
                         f"{lists[0]}+{lists[1]} blocks, {len(refs)} slots")


def mc_table_case(dev, table, lists, refs, shp_y, shp_c, bd, shape,
                  main_taps=False, order=None):
    """The MC kernel and its plain version on one block table (int32
    [N, 10], host or device) and per-slot reference planes on `dev`;
    `order`: the table's class order on `dev` (built here by default).
    `reset` is a no-op: each launch writes new planes."""
    tab = device_tables(dev)
    mc = _dev(np.asarray(table, np.int32), dev) if isinstance(
        table, np.ndarray) else table
    order = order or mc_order_on(dev, table, lists)
    return KernelCase(
        "mc", shape,
        lambda: list(TM.mc_all(mc, lists, refs, shp_y, shp_c, bd, tab,
                               main_taps, order=order)),
        lambda: list(TM.mc_all_ref(mc, refs, shp_y, shp_c, bd, tab,
                                   main_taps)),
        *mc_work(table), reset=lambda: None)


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
def suco_runs_on(dev, row_off, edges):
    """K10's run table (ops/pack.py `suco_runs`) of a host edge table, its
    arrays on `dev`, as the pack uploads it."""
    r = PK.suco_runs(_host(row_off), _host(edges))
    return PK.SucoRuns(_dev(r.row_runs, dev), _dev(r.run_off, dev),
                       _dev(r.entries, dev), r.row_runs_max,
                       r.row_entries_max)


def suco_work(row_off, edges, runs):
    """(bytes, ops) of K10 on an edge table: per edge and plane with a
    strength, A..D read and B, C written on both lines of its SCU row
    (int16), about 14 operations a line; the run table read."""
    e = _host(edges)
    on = int((e[:, PK.SE_ST_U:] > 0).sum())
    table = sum(int(np.asarray(_host(a)).size) for a in (
        runs.row_runs, runs.run_off, runs.entries))
    return on * 2 * 6 * 2 + 4 * table, on * 2 * 14


def suco_planes_case(dev, u, v, row_off, edges, bd, shape, runs=None):
    """K10 on chroma areas u, v (views into device planes, left untouched:
    each side filters copies of its own, with the pitch the path gives)
    with the edge table row_off, edges (host or device) and its run table
    on the device (built here from the edge table by default)."""
    off, ed = (_dev(np.asarray(a), dev) if isinstance(a, np.ndarray) else a
               for a in (row_off, edges))
    runs = runs or suco_runs_on(dev, off, ed)
    a, b, views, reset = _planes_copies([u, v])
    ka, kb = views(a), views(b)     # made once: the kernel's time is its own
    return KernelCase(
        "chroma_ver_ordered", shape,
        lambda: (TD.chroma_ver_ordered(*ka, off, ed, bd, runs=runs), a)[1],
        lambda: (TD.chroma_ver_ordered_ref(*kb, off, ed, bd), b)[1],
        *suco_work(off, ed, runs), reset=reset)


def suco_case(dev, bd, h_scu, w_scu, seed=0, kind="random"):
    """K10 on synthetic chroma planes (views into bordered planes) with an
    edge table of one kind (`suco_lists`)."""
    rng = np.random.default_rng(seed + bd + 3 * SUCO_LISTS.index(kind))
    H, W = 2 * h_scu, 2 * w_scu
    planes = []
    for _ in range(2):
        p = bordered(rng, H, W, 0, 1 << bd)
        p[BORDER:BORDER + H, BORDER:BORDER + W] = smooth_plane(rng, H, W, bd,
                                                               8)
        planes.append(_dev(p, dev)[BORDER:BORDER + H, BORDER:BORDER + W])
    row_off, edges = suco_lists(rng, kind, h_scu, w_scu)
    runs = PK.suco_runs(row_off, edges)
    return suco_planes_case(
        dev, *planes, row_off, edges, bd,
        f"{H}x{W} bd{bd} {kind} lists, {len(edges)} edges, longest run "
        f"{int(np.diff(runs.run_off).max()) if len(edges) else 0}")


def _addb_edge_masks(bs, B, H, W):
    """(read, written) bool [H, W] of one plane's ADDB edges with bs > 0:
    bs the map's bs channel [2, H/u, W/u] (u = B/2); a line reads B and
    writes B - 2 samples across its edge."""
    read = np.zeros((H, W), bool)
    written = np.zeros((H, W), bool)
    u = B // 2
    ver = bs[0][:, 2::2].repeat(u, 0) > 0          # [H, W/B - 1]
    hor = bs[1][2::2, :].repeat(u, 1) > 0          # [H/B - 1, W]
    n_x, n_y = W // B - 1, H // B - 1
    for k in range(-B // 2, B // 2):
        m = (read, written) if -B // 2 < k < B // 2 - 1 else (read,)
        for t in m:
            t[:, B + k::B][:, :n_x] |= ver[:, :n_x]
            t[B + k::B][:n_y] |= hor[:n_y]
    return read, written, int(ver.sum() + hor.sum())


def addb_frame_work(luma_pars, chroma_pars, chroma):
    """(bytes, ops) of ADDB on one picture: each sample an edge with bs > 0
    reads, read once, each it writes, written once (int16); every cell on
    the edge grid's bs (4 bytes), and for cells with bs > 0 the other
    channels the filter reads (luma 3, chroma 3 for U and 3 for V); about
    60 operations a luma line, 25 a chroma line."""
    lp = _host(luma_pars)
    planes = [(lp[..., 0], 8, lp.shape[1] * 4, lp.shape[2] * 4, 60, 3)]
    if chroma:
        cp = _host(chroma_pars)
        planes.append((cp[..., 0], 4, cp.shape[1] * 2, cp.shape[2] * 2, 25,
                       6))
    nbytes = ops = 0
    for bs, B, H, W, line_ops, nch in planes:
        read, written, lines = _addb_edge_masks(bs, B, H, W)
        on = int((bs[0][:, 2::2] > 0).sum() + (bs[1][2::2] > 0).sum())
        cells = bs[0][:, 2::2].size + bs[1][2::2].size
        copies = 2 if B == 4 else 1                    # U and V
        nbytes += copies * 2 * int(read.sum() + written.sum())
        nbytes += 4 * cells + 4 * nch * on
        ops += copies * lines * line_ops
    return nbytes, ops


def _two_copies(area):
    """(a, b, view): two copies of the whole plane (or GOP batch of planes)
    `area` is a view into, and view(copy), the same view into a copy -- so
    that a kernel and its plain version each filter a plane of their own
    in place, with the row pitch and border the main path gives them."""
    base = area
    while base._base is not None:
        base = base._base
    off, shape, stride = area.storage_offset(), tuple(area.shape), \
        area.stride()
    return (base.clone(), base.clone(),
            lambda t: t.as_strided(shape, stride, off))


def _planes_copies(areas):
    """(a, b, views, reset): two copies of the planes (None kept) the areas
    are views into, the same views into each copy, and a function that
    restores copy a -- so that a kernel and its plain version each work on
    planes of their own, with the pitch and border the main path gives."""
    pairs = [None if t is None else _two_copies(t) for t in areas]
    a = [None if p is None else p[0] for p in pairs]
    b = [None if p is None else p[1] for p in pairs]
    src = [None if t is None else t.clone() for t in a]

    def views(copies):
        return [None if p is None else p[2](c) for p, c in zip(pairs, copies)]

    def reset():
        for x, r in zip(a, src):
            if x is not None:
                x.copy_(r)
    return a, b, views, reset


def addb_frame_case(dev, areas, luma_pars, chroma_pars, bd, shape):
    """ADDB of one picture on `areas` (y, u, v views into device planes,
    left untouched; u, v None for 4:0:0) with the maps on the device: the
    fused kernel against `addb_frame_ref`, each on planes of its own (the
    whole planes compared: nothing outside the areas may change)."""
    a, b, views, reset = _planes_copies(areas)
    chroma = areas[1] is not None
    return KernelCase(
        "addb_frame", shape,
        lambda: (TA.addb_frame(*views(a), luma_pars, chroma_pars, bd), a)[1],
        lambda: (TA.addb_frame_ref(*views(b), luma_pars, chroma_pars, bd),
                 b)[1],
        *addb_frame_work(luma_pars, chroma_pars, chroma), reset)


def _padded(rng, H, W, bd, extra=0):
    """A bordered int16 plane on the host with a smooth H x W area; `extra`
    columns more make the row pitch unaligned."""
    plane = bordered(rng, H, W + extra, 0, 1 << bd)
    plane[BORDER:BORDER + H, BORDER:BORDER + W] = smooth_plane(rng, H, W, bd)
    return plane


def addb_synth_case(dev, bd, H, W, seed=0, chroma=True, maps="dense",
                    unaligned=False):
    """ADDB of a synthetic H x W picture (H, W multiples of 8; chroma H/2 x
    W/2 or 4:0:0) on bordered planes with random maps: "dense" (random bs),
    "strong" (bs 4 everywhere) or "none"; `unaligned` gives every plane an
    odd row pitch, so the kernel reads sample by sample."""
    rng = np.random.default_rng(seed + bd + 2 * chroma)
    extra = 1 if unaligned else 0
    planes = [_padded(rng, H, W, bd, extra)] + [
        _padded(rng, H // 2, W // 2, bd, extra) if chroma else None
        for _ in range(2)]
    pars = [addb_pars(rng, H // 4, W // 4, bd, n) for n in (4, 7)]
    for m in pars:
        if maps != "dense":
            m[..., 0] = 4 if maps == "strong" else 0
    d = [_dev(p, dev) for p in planes]
    areas = [d[0][BORDER:BORDER + H, BORDER:BORDER + W]] + [
        None if t is None
        else t[BORDER:BORDER + H // 2, BORDER:BORDER + W // 2] for t in d[1:]]
    return addb_frame_case(
        dev, areas, _dev(pars[0], dev), _dev(pars[1], dev), bd,
        f"{W}x{H} bd{bd} {'4:2:0' if chroma else '4:0:0'} {maps} maps"
        f"{' unaligned pitch' if unaligned else ''}")


def alf_frame_work(areas, ctu_on, h, w, cfg, coef_l, coef_c):
    """(bytes, ops, copy bytes) of ALF on one picture: each filtered plane
    read once and its filtered samples written once (luma: the CTUs whose
    flag is set; chroma: all), the coefficients; about 64 operations a
    filtered luma sample (four Laplacians and their group sums, the
    classification, the 13-tap filter), 23 a chroma sample.  Copy bytes:
    the unflagged luma CTUs the kernel copies to its output plane (read
    and written), the design's cost, not the function's."""
    nbytes = ops = copy = 0
    for i, _, ph, pw, log2_s in TL._planes(*areas, h, w, cfg):
        S = 1 << log2_s
        n_w, n_h = -(-pw // S), -(-ph // S)
        idx = np.arange(n_w * n_h)
        size = np.minimum(S, pw - idx % n_w * S) * \
            np.minimum(S, ph - idx // n_w * S)
        on = _host(ctu_on) > 0 if i == 0 else np.ones(len(idx), bool)
        samples = int(size[on].sum())
        nbytes += ph * pw * 2 + samples * 2
        ops += samples * (64 if i == 0 else 23)
        copy += 4 * int(size[~on].sum())
    nbytes += (coef_l.numel() if cfg[0][0] else 0) * 4
    nbytes += (coef_c.numel() if any(cfg[0][1:]) else 0) * 4
    return nbytes, ops, copy


def alf_frame_case(dev, areas, coef_l, coef_c, ctu_on, h, w, cfg, bd,
                   shape):
    """ALF of one picture on `areas` (views into device planes, left
    untouched): the kernel against `alf_frame_ref`, each reading copies of
    the planes of its own; compared are each returned plane's h x w
    (chroma h/2 x w/2) part and the whole planes read (which neither may
    change)."""
    a, b, views, _ = _planes_copies(areas)
    crops = [(h, w), (h >> 1, w >> 1), (h >> 1, w >> 1)]

    def run(alf, planes):
        outs = alf(*views(planes), coef_l, coef_c, ctu_on, h, w, cfg, bd)
        return [None if p is None else p[:ph, :pw]
                for p, (ph, pw) in zip(outs, crops)] + planes
    nbytes, ops, copy = alf_frame_work(areas, ctu_on, h, w, cfg, coef_l,
                                       coef_c)
    return KernelCase(
        "alf_frame", shape, lambda: run(TL.alf_frame, a),
        lambda: run(TL.alf_frame_ref, b), nbytes, ops, reset=lambda: None,
        copy_bytes=copy)


def alf_synth_case(dev, bd, h, w, log2_ctu, across, seed=0,
                   enables=(True, True, True), unaligned=False):
    """ALF of a synthetic h x w picture on the SCU-rounded areas of
    bordered planes of random samples, random coefficients and CTU flags
    (a third off); `unaligned` gives every plane an odd row pitch."""
    rng = np.random.default_rng(seed + bd + 2 * log2_ctu + across)
    extra = 1 if unaligned else 0
    d = [_dev(bordered(rng, ph + 8, pw + 8 + extra, 0, 1 << bd), dev)
         for ph, pw in ((h, w), (h >> 1, w >> 1), (h >> 1, w >> 1))]
    areas = [t[BORDER:BORDER + ph + 4, BORDER:BORDER + pw + 4]
             for t, (ph, pw) in zip(d, ((h, w), (h >> 1, w >> 1),
                                        (h >> 1, w >> 1)))]
    cl, cc = alf_coefs(rng)
    S = 1 << log2_ctu
    n_ctu = -(-h // S) * -(-w // S)
    ctu_on = _dev((rng.random(n_ctu) < 0.7).astype(np.int32), dev)
    cfg = (tuple(enables), log2_ctu, bool(across))
    return alf_frame_case(
        dev, areas, _dev(cl, dev), _dev(cc, dev), ctu_on, h, w, cfg, bd,
        f"{w}x{h} CTU {S} bd{bd} across {int(across)} planes "
        f"{''.join('YUV'[i] for i in range(3) if enables[i])}"
        f"{' unaligned pitch' if unaligned else ''}")


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


# --------------------------------------------------------------------------
# the GOP batch (K15): the batched kernels on one time step of a batch
# --------------------------------------------------------------------------
# the Baseline passes in reference order (xevd_tpu/ops/pipeline.py:
# 299-309): (pass, plane, map of dbst)
DEBLOCK_ORDER = (("luma_ver", 0, 0), ("chroma_ver", 1, 2),
                 ("chroma_ver", 2, 4), ("luma_hor", 0, 1),
                 ("chroma_hor", 1, 3), ("chroma_hor", 2, 5))


def gop_step_plain(batch, tables, dpb):
    """K15's plain step: the batched plain versions of
    ops/pipeline.run_frames_device's stages, in its order, on its inputs;
    returns the padded pictures (y, u, v) [G, ...] (dpb.out is untouched)."""
    pb = batch.packed
    bd, chroma = pb.bd, pb.chroma
    resids = TQ.itdq_batch_ref((batch.coef_y, batch.coef_u, batch.coef_v),
                               batch.tus, batch.tu_off, pb.shp_y, pb.shp_c,
                               bd, tables, pb.iqt)
    if batch.mc.shape[0]:
        p = TM.mc_all_batch_ref(batch.mc, batch.mc_off, dpb.refs, pb.shp_y,
                                pb.shp_c, bd, tables, pb.main_taps)
        preds = ((p[0], p[1]), (p[2], p[4]), (p[3], p[4]))
    else:
        preds = ((None, None),) * 3
    recs = [None if r is None else TR.recon_ref(r, bd, *q)
            for r, q in zip(resids, preds)]
    TI.intra_scan_batch_ref(recs, resids, batch.icu, batch.icu_off, bd,
                            chroma)
    h, w, h_scu, w_scu = pb.geom
    areas = _batch_areas(recs, h_scu, w_scu)
    if pb.deblock_on:
        for kind, plane, k in DEBLOCK_ORDER:
            if areas[plane] is not None:
                TD.deblock_pass_ref(kind, areas[plane], batch.dbst[:, k], bd)
    return [TR.pad_ref(areas[0], h, w, PAD_L)] + [
        None if a is None else TR.pad_ref(a, h >> 1, w >> 1, PAD_C)
        for a in areas[1:]]


def _batch_areas(recs, h_scu, w_scu):
    """The SCU-area views of a batch's bordered planes (chroma None for
    4:0:0)."""
    H4, W4 = h_scu * 4, w_scu * 4
    return [recs[0][:, BORDER:BORDER + H4, BORDER:BORDER + W4]] + [
        None if r is None else
        r[:, BORDER:BORDER + H4 // 2, BORDER:BORDER + W4 // 2]
        for r in recs[1:]]


def gop_step_cases(dev, caps, t=1, plain_device=None):
    """The batched kernels and K15's step against their batched plain
    versions on time step `t` of the GOP batch of `caps` (every GOP on one
    device; parallel/gop.py `_capture_gop` captures) on `dev`: the step's
    own tables, its DPB after steps 0 .. t - 1 (decoded by the kernels),
    and each stage's input as the batched path gives it (the kernels'
    outputs of the stages before it).  Step 0 (the GOPs' I pictures) has
    no MC case and recon without a prediction; the intra scan walks the
    batch's ticket order (ops/pack.py `icu_order`) against the plain
    version's frame after frame.  With `plain_device`, the intra scan's
    and the step's plain versions (a tensor operation a CU) run on copies
    of their inputs there."""
    from xevd_tpu_torch.ops.pipeline import DpbStep, run_frames_device
    from xevd_tpu_torch.parallel import gop as TG

    D, [(gops, steps)] = TG._plan(caps, 1)
    h, w = caps[0][0]["pack"].geom[:2]
    run = TG._DeviceRun(dev, gops, steps, D, h, w)
    for s in range(t):
        run.step(s)
    run.finish()
    pb = steps[t]
    G, bd, chroma = pb.G, pb.bd, pb.chroma
    tab = device_tables(dev)
    b = PK.upload_batch(pb, dev)
    dpb = run.dpb(t, G)
    label = f"G {G}, step {t}"
    cases = []
    q = ((b.coef_y, b.coef_u, b.coef_v), b.tus, pb.shp_y, pb.shp_c, bd, tab,
         pb.iqt)
    cases.append(KernelCase(
        "itdq", f"{label}, {b.tus.shape[0]} TUs",
        lambda: list(TQ.itdq(*q, tu_off=b.tu_off, order=b.tu_order)),
        lambda: list(TQ.itdq_batch_ref(*q[:2], b.tu_off, *q[2:])),
        *itdq_work(b.tus), reset=lambda: None))
    resids = TQ.itdq(*q, tu_off=b.tu_off, order=b.tu_order)
    n = resids[0].numel()
    if b.mc.shape[0]:
        m = (pb.shp_y, pb.shp_c, bd, tab, pb.main_taps)
        cases.append(KernelCase(
            "mc", f"{label}, {b.mc.shape[0]} blocks",
            lambda: list(TM.mc_all(b.mc, pb.mc_lists, dpb.refs, *m,
                                   mc_off=b.mc_off, order=b.mc_order)),
            lambda: list(TM.mc_all_batch_ref(b.mc, b.mc_off, dpb.refs, *m)),
            *mc_work(b.mc), reset=lambda: None))
        p = TM.mc_all(b.mc, pb.mc_lists, dpb.refs, *m, mc_off=b.mc_off,
                      order=b.mc_order)
        preds = ((p[0], p[1]), (p[2], p[4]), (p[3], p[4]))
        cases.append(KernelCase(
            "recon", f"{label}, luma {tuple(p[0].shape)} with prediction",
            lambda: [TR.recon(resids[0], bd, *preds[0])],
            lambda: [TR.recon_ref(resids[0], bd, *preds[0])], n * 9, n * 6))
    else:                       # an intra step (step 0): no MC
        preds = ((None, None),) * 3
        cases.append(KernelCase(
            "recon", f"{label}, luma {tuple(resids[0].shape)}",
            lambda: [TR.recon(resids[0], bd)],
            lambda: [TR.recon_ref(resids[0], bd)], n * 4, n * 2))
    recs = [None if r is None else TR.recon(r, bd, *pr)
            for r, pr in zip(resids, preds)]
    depth = TI.intra_dag_depth(b.icu, *pb.geom[2:], icu_off=b.icu_off)
    cases.append(intra_planes_case(
        dev, recs, resids, b.icu, bd, chroma,
        f"{label}, {b.icu.shape[0]} CUs, depth {depth}", icu_off=b.icu_off,
        order=b.icu_order, plain_device=plain_device))
    TI.intra_scan(recs, resids, b.icu, bd, chroma, icu_off=b.icu_off,
                  order=b.icu_order)
    # each kernel on the areas it filters on the path, then run on them:
    # luma (both passes, one launch), then the chroma passes (the reference
    # order runs luma hor after chroma ver, which touches only U and V)
    areas = _batch_areas(recs, *pb.geom[2:])
    cases.append(deblock_luma_area_case(
        dev, areas[0], b.dbst[:, 0], b.dbst[:, 1], bd,
        f"{label}, Y {tuple(areas[0].shape)}"))
    TD.deblock_luma(areas[0], b.dbst[:, 0], b.dbst[:, 1], bd)
    for kind, plane, k in DEBLOCK_ORDER:
        if plane == 0:
            continue
        st = b.dbst[:, k]
        if plane == 1:
            x, y, view = _two_copies(areas[plane])
            cases.append(KernelCase(
                f"deblock_{kind}", f"{label}, U {tuple(areas[plane].shape)}",
                lambda x=x, view=view, st=st, kind=kind: (
                    TD.deblock_pass(kind, view(x), st, bd), [x])[1],
                lambda y=y, view=view, st=st, kind=kind: (
                    TD.deblock_pass_ref(kind, view(y), st, bd), [y])[1],
                *deblock_work(kind, st)))
        TD.deblock_pass(kind, areas[plane], st, bd)
    cases.append(pad_areas_case(
        dev, areas, h, w, chroma,
        f"{label}, {'Y, U, V' if chroma else 'Y'} {h}x{w}", out=dpb.out))
    out = DpbStep(dpb.refs, tuple(torch.zeros_like(o) for o in dpb.out))
    # the step's own traffic: its payload and coefficients, the reference
    # windows, the pictures written; the operations of its stages
    win = mc_work(b.mc)[0] - 5 * int(
        (b.mc[:, PK.MC_W] * b.mc[:, PK.MC_H]
         * (1 + (b.mc[:, PK.MC_PLANE] > 0))).sum())
    step_bytes = (pb.payload.nbytes + pb.coefs.nbytes + win
                  + sum(o.numel() * 2 for o in dpb.out))
    if plain_device is None:
        pbatch, ptab, pdpb = b, tab, dpb
    else:
        pbatch = PK.upload_batch(pb, plain_device)
        ptab = device_tables(plain_device)
        pdpb = DpbStep(TM.DpbRing(tuple(_to(p, plain_device)
                                        for p in dpb.refs.planes), t), None)
    cases.append(KernelCase(
        "gop_step", f"{label}, {G} x {h}x{w} pictures",
        lambda: list(run_frames_device(b, tab, out)),
        lambda: gop_step_plain(pbatch, ptab, pdpb),
        step_bytes, sum(c.ops for c in cases), graph_calls=1))
    return cases


# --------------------------------------------------------------------------
# the stage-diff tool (xevd_tpu_torch/diff.py --stages)
# --------------------------------------------------------------------------
def raise_chroma_ver_strength(job):
    """A planted fault for the stage-diff tool, on one side's job: the first
    U vertical edge with a strength raised to 64, its map replaced (with
    deblocking off the decoder shares one zero map among all six)."""
    m = np.array(job.db_ver_u)
    on = np.flatnonzero(m)
    if len(on):
        m.flat[on[0]] = 64
    job.db_ver_u = m
