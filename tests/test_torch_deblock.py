"""Baseline deblocking of the PyTorch port against the JAX package
(`jax_deblock` passes and `pipeline._deblock_finish`; exact: integer).
The CUDA kernels are held to the plain versions in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xevd_tpu.ops import jax_deblock as JD
from xevd_tpu.ops import pipeline as PL
from xevd_tpu_torch.ops import deblock as TD
from xevd_tpu_torch.ops import recon as TR
from xevd_tpu_torch.ops.tables import BORDER, PAD_L

from .torch_helpers import (CHROMA_MAPS, LUMA_MAPS, bordered, chroma_map,
                            deblock_luma_work, luma_maps, run_lengths,
                            smooth_plane, strengths)


# pass name -> (JAX pass, SCU size, axis the JAX strength map repeats on)
PASSES = {"luma_ver": (JD.luma_ver_pass, 4, 0),
          "luma_hor": (JD.luma_hor_pass, 4, 1),
          "chroma_ver": (JD.chroma_ver_pass, 2, 0),
          "chroma_hor": (JD.chroma_hor_pass, 2, 1)}


@pytest.mark.parametrize("kind", list(PASSES))
@pytest.mark.parametrize("bd", [8, 10])
def test_pass_matches_jax(kind, bd):
    fn, u, axis = PASSES[kind]
    rng = np.random.default_rng(bd * 7 + len(kind))
    H, W = 16 * u, 24 * u
    plane = rng.integers(0, 1 << bd, size=(H, W)).astype(np.int16)
    st = strengths(rng, H // u, W // u)[0]
    want = np.asarray(fn(jnp.asarray(plane),
                         jnp.asarray(np.repeat(st, u, axis=axis)), bd))
    got = torch.from_numpy(plane.copy())
    TD.deblock_pass(kind, got, torch.from_numpy(st), bd)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("chroma", [True, False])
@pytest.mark.parametrize("bd", [8, 10])
def test_deblock_finish_matches_jax(chroma, bd):
    """K12 and K14 together: crop to the SCU area, the passes in
    reference order, then pad-expand."""
    rng = np.random.default_rng(40 + bd + chroma)
    h, w = 60, 100                       # picture; SCU grid 15 x 25
    h_scu, w_scu = (h + 3) // 4, (w + 3) // 4
    h_pad, w_pad = 64, 128
    recs = [bordered(rng, h_pad, w_pad, 0, 1 << bd)]
    recs += [bordered(rng, h_pad // 2, w_pad // 2, 0, 1 << bd)
             for _ in range(2)]
    st = strengths(rng, h_scu, w_scu, 6)
    geom = (h, w, h_scu, w_scu)
    jr = (jnp.asarray(recs[0]), jnp.asarray(recs[1]) if chroma else None,
          jnp.asarray(recs[2]) if chroma else None)
    want = PL._deblock_finish(jr, jnp.asarray(st), None, geom, bd, chroma,
                              True, PAD_L)
    t = [torch.from_numpy(p.copy()) for p in recs]
    H4, W4 = h_scu * 4, w_scu * 4
    ya = t[0][BORDER:BORDER + H4, BORDER:BORDER + W4]
    ua = t[1][BORDER:BORDER + H4 // 2, BORDER:BORDER + W4 // 2]
    va = t[2][BORDER:BORDER + H4 // 2, BORDER:BORDER + W4 // 2]
    TD.deblock_frame(ya, ua if chroma else None, va if chroma else None,
                     torch.from_numpy(st), bd)
    got = [p for p in TR.pad_picture(ya, ua if chroma else None,
                                     va if chroma else None, h, w, chroma)
           if p is not None]
    assert len([x for x in want if x is not None]) == len(got)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


@pytest.mark.parametrize("maps", CHROMA_MAPS)
@pytest.mark.parametrize("kind", ["chroma_ver", "chroma_hor"])
@pytest.mark.parametrize("bd", [8, 10])
def test_chroma_runs_in_any_order_match_jax(kind, bd, maps):
    """K9's run decomposition (csrc/deblock.cu): each run of consecutive
    edges with a strength filtered as one chain carrying A, the runs in
    three random orders, equals the plain pass and JAX's -- on random maps
    (short runs), maps with every edge on (one run a line) and no edge."""
    fn, u, axis = PASSES[kind]
    rng = np.random.default_rng(50 + bd + len(kind) + len(maps))
    H, W = 20 * u, 28 * u
    plane = rng.integers(0, 1 << bd, size=(H, W)).astype(np.int16)
    st = chroma_map(rng, maps, H // u, W // u)
    runs = run_lengths(st, kind)
    if maps == "all":
        assert (runs == (W if kind == "chroma_ver" else H) // 2 - 1).all()
    assert (len(runs) == 0) == (maps == "zero")
    want = np.asarray(fn(jnp.asarray(plane),
                         jnp.asarray(np.repeat(st, u, axis=axis)), bd))
    ref = torch.from_numpy(plane.copy())
    TD.deblock_pass(kind, ref, torch.from_numpy(st), bd)
    np.testing.assert_array_equal(ref.numpy(), want)
    for seed in range(3):
        got = torch.from_numpy(plane.copy())
        TD.chroma_runs_ref(kind, got, torch.from_numpy(st), bd,
                           np.random.default_rng(seed))
        np.testing.assert_array_equal(got.numpy(), want)


def _jax_luma(plane, st_ver, st_hor, bd):
    """JAX's two luma passes, ver then hor, with the per-SCU maps expanded
    as `_deblock_finish` expands them (xevd_tpu/ops/pipeline.py:300,306)."""
    p = JD.luma_ver_pass(jnp.asarray(plane),
                         jnp.asarray(np.repeat(st_ver, 4, axis=0)), bd)
    return np.asarray(JD.luma_hor_pass(
        p, jnp.asarray(np.repeat(st_hor, 4, axis=1)), bd))


@pytest.mark.parametrize("maps", LUMA_MAPS)
@pytest.mark.parametrize("shape", [(16, 32), (64, 96), (3, 16, 32)])
@pytest.mark.parametrize("bd", [8, 10])
def test_luma_blocks_in_any_order_match_jax(shape, bd, maps):
    """K8's fused order (csrc/deblock.cu `luma_kernel`): each shifted 4x4
    block filtered ver edge then hor edge, the blocks in raster order and
    in three random orders (`luma_blocks_ref`), and `deblock_luma` on the
    CPU, equal JAX's `luma_ver_pass` then `luma_hor_pass` -- on random
    maps, every edge at the largest strength, no edge, vertical edges only
    and horizontal edges only; on one area, a non-square one and a batch
    of three areas with maps of their own."""
    rng = np.random.default_rng(60 + bd + 7 * len(shape) + shape[-1]
                                + len(maps))
    G = shape[0] if len(shape) == 3 else None
    H, W = shape[-2:]
    frames = [smooth_plane(rng, H, W, bd) for _ in range(G or 1)]
    sts = [luma_maps(rng, maps, H // 4, W // 4) for _ in range(G or 1)]
    want = np.stack([_jax_luma(p, *st, bd) for p, st in zip(frames, sts)])
    plane = np.stack(frames)
    assert (want == plane).all() == (maps == "zero")
    if G is None:
        plane, want = plane[0], want[0]
        st_ver, st_hor = (torch.from_numpy(m) for m in sts[0])
    else:
        st_ver, st_hor = (torch.from_numpy(np.stack(m)) for m in zip(*sts))
        assert not torch.equal(st_ver[0], st_ver[1]) or maps in (
            "all", "zero", "hor")
    got = torch.from_numpy(plane.copy())
    TD.deblock_luma(got, st_ver, st_hor, bd)
    np.testing.assert_array_equal(got.numpy(), want)
    for rng_ in (None, *(np.random.default_rng(s) for s in range(3))):
        got = torch.from_numpy(plane.copy())
        TD.luma_blocks_ref(got, st_ver, st_hor, bd, rng_)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["luma_ver", "luma_hor"])
def test_single_luma_pass_is_the_fused_order_with_one_map(kind):
    """`deblock_pass("luma_ver" | "luma_hor")` (on the card: the fused
    kernel with the other map absent) equals `luma_blocks_ref` with that
    map alone, and JAX's pass."""
    fn, u, axis = PASSES[kind]
    rng = np.random.default_rng(70 + len(kind))
    plane = smooth_plane(rng, 64, 96, 8)
    st = strengths(rng, 16, 24)[0]
    want = np.asarray(fn(jnp.asarray(plane),
                         jnp.asarray(np.repeat(st, u, axis=axis)), 8))
    got = torch.from_numpy(plane.copy())
    TD.deblock_pass(kind, got, torch.from_numpy(st), 8)
    np.testing.assert_array_equal(got.numpy(), want)
    maps = (torch.from_numpy(st), None)[::1 if kind == "luma_ver" else -1]
    got = torch.from_numpy(plane.copy())
    TD.luma_blocks_ref(got, *maps, 8, np.random.default_rng(1))
    np.testing.assert_array_equal(got.numpy(), want)


def test_deblock_luma_work_counts_the_samples_edges_reach():
    """The fused kernel's bound: every sample a luma edge with a strength
    reaches, read and written once, counted against a brute-force walk of
    the edges; both maps read."""
    rng = np.random.default_rng(80)
    sv, sh = luma_maps(rng, "random", 6, 10)
    reached = np.zeros((24, 40), bool)
    for f in range(6):
        for e in range(1, 10):
            if sv[f, e] > 0:
                reached[4 * f:4 * f + 4, 4 * e - 2:4 * e + 2] = True
    for f in range(1, 6):
        for e in range(10):
            if sh[f, e] > 0:
                reached[4 * f - 2:4 * f + 2, 4 * e:4 * e + 4] = True
    lines = 4 * int((sv[:, 1:] > 0).sum() + (sh[1:] > 0).sum())
    assert deblock_luma_work(sv, sh) == (4 * int(reached.sum())
                                         + 2 * sv.size * 4, 20 * lines)
    assert deblock_luma_work(sv, None)[1] == 80 * int((sv[:, 1:] > 0).sum())


def test_pass_rejects_mismatched_strengths():
    with pytest.raises(ValueError):
        TD.deblock_pass("luma_ver", torch.zeros(16, 32, dtype=torch.int16),
                        torch.zeros(4, 4, dtype=torch.int32), 8)
    area = torch.zeros(16, 32, dtype=torch.int16)
    st = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(ValueError):       # no map at all
        TD.deblock_luma(area, None, None, 8)
    with pytest.raises(ValueError):       # a batch map beside one area
        TD.deblock_luma(area, st, st[None], 8)
    with pytest.raises(ValueError):       # not a multiple of 4
        TD.deblock_luma(area[:, :30], st, None, 8)
