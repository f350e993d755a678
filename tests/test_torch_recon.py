"""Recon and pad-expand of the PyTorch port against the JAX package
(`_recon_all`, `_pad_out`; exact: integer).  The Triton kernels are held
to the plain versions in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xevd_tpu.ops import pipeline as PL
from xevd_tpu_torch.ops import recon as TR
from xevd_tpu_torch.ops.tables import PAD_L

from .torch_helpers import recon_planes


@pytest.mark.parametrize("bd", [8, 10])
def test_recon_matches_jax_recon_all(bd):
    """An intra frame: zero prediction and count planes on the JAX side."""
    pl = recon_planes(bd)
    zp = [jnp.zeros(r.shape, jnp.int32) for r in pl]
    zc = [jnp.zeros(r.shape, jnp.int8) for r in pl]
    want = PL._recon_all(tuple(jnp.asarray(r) for r in pl),
                         (zp[0], zc[0], zp[1], zp[2], zc[1]), bd, True)
    for r, w in zip(pl, want, strict=True):
        got = TR.recon(torch.from_numpy(r), bd)
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


@pytest.mark.parametrize("h,w", [(64, 64), (90, 150)])
@pytest.mark.parametrize("chroma", [True, False])
def test_pad_matches_jax_pad_out(h, w, chroma):
    rng = np.random.default_rng(h * w)
    ya = rng.integers(0, 1024, size=(96, 160)).astype(np.int16)
    ua = rng.integers(0, 1024, size=(48, 80)).astype(np.int16)
    va = rng.integers(0, 1024, size=(48, 80)).astype(np.int16)
    want = PL._pad_out(jnp.asarray(ya), jnp.asarray(ua), jnp.asarray(va),
                       h, w, chroma, PAD_L)
    got = [TR.pad(torch.from_numpy(ya), h, w, PAD_L)]
    if chroma:
        got += [TR.pad(torch.from_numpy(a), h >> 1, w >> 1, PAD_L >> 1)
                for a in (ua, va)]
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    assert chroma or want[1] is None


def test_pad_of_strided_view():
    """The pipeline pads a view into the bordered plane (a row pitch)."""
    rng = np.random.default_rng(3)
    big = torch.from_numpy(rng.integers(0, 256, size=(50, 70))
                           .astype(np.int16))
    view = big[5:37, 7:55]
    np.testing.assert_array_equal(
        TR.pad(view, 30, 40, 8).numpy(),
        np.pad(view.numpy()[:30, :40], 8, mode="edge"))
