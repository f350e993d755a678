"""Baseline intra scan of the PyTorch port against the JAX package
(`jax_intra.intra_scan`; exact: integer).  The CUDA kernel is held to the
plain version in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xevd_tpu.ops import jax_intra as JI
from xevd_tpu_torch.ops import intra as TI

from .torch_helpers import intra_scene


def _jax_scan(recs, res, icu, bd, chroma):
    cu = {k: jnp.asarray(icu[:, i]) for i, k in enumerate(
        ("x", "y", "log2", "ipm", "up_mask", "left_mask", "corner",
         "valid"))}
    out = JI.intra_scan(tuple(jnp.asarray(p) for p in recs),
                        tuple(jnp.asarray(p) for p in res), cu, bd, chroma)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("H,W", [(64, 64), (48, 96)])
@pytest.mark.parametrize("bd", [8, 10])
def test_intra_scan_matches_jax(H, W, bd):
    recs, res, icu = intra_scene(H, W, bd, seed=H * W + bd)
    want = _jax_scan(recs, res, icu, bd, True)
    got = TI.intra_scan([torch.from_numpy(p.copy()) for p in recs],
                        [torch.from_numpy(p) for p in res],
                        torch.from_numpy(icu), bd, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_intra_scan_luma_only_matches_jax():
    recs, res, icu = intra_scene(64, 64, 8, seed=11)
    want = _jax_scan(recs, res, icu, 8, False)
    got = TI.intra_scan([torch.from_numpy(p.copy()) for p in recs],
                        [torch.from_numpy(p) for p in res],
                        torch.from_numpy(icu), 8, False)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), recs[1])   # untouched
