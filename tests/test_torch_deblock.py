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

from .torch_helpers import (CHROMA_MAPS, bordered, chroma_map, run_lengths,
                            strengths)


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


def test_pass_rejects_mismatched_strengths():
    with pytest.raises(ValueError):
        TD.deblock_pass("luma_ver", torch.zeros(16, 32, dtype=torch.int16),
                        torch.zeros(4, 4, dtype=torch.int32), 8)
