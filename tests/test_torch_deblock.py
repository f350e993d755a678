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
from xevd_tpu_torch.ops.tables import BORDER, PAD_C, PAD_L

from .torch_helpers import bordered, strengths


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
    got = [TR.pad(ya, h, w, PAD_L)]
    if chroma:
        got += [TR.pad(a, h // 2, w // 2, PAD_C) for a in (ua, va)]
    assert len([x for x in want if x is not None]) == len(got)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_pass_rejects_mismatched_strengths():
    with pytest.raises(ValueError):
        TD.deblock_pass("luma_ver", torch.zeros(16, 32, dtype=torch.int16),
                        torch.zeros(4, 4, dtype=torch.int32), 8)
