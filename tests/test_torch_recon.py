"""Recon and pad-expand of the PyTorch port against the JAX package
(`_recon_all`, `_pad_out`; exact: integer): `pad_picture` pads a
picture's planes as `_pad_out` pads them, and a GOP batch's pictures each
as on its own.  The recon (Triton) and pad (CUDA) kernels are held to
the plain versions in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xevd_tpu.ops import pipeline as PL
from xevd_tpu_torch.ops import recon as TR
from xevd_tpu_torch.ops.tables import PAD_C, PAD_L

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


@pytest.mark.parametrize("h,w", [(64, 64), (90, 150), (37, 51)])
@pytest.mark.parametrize("chroma", [True, False])
def test_pad_matches_jax_pad_out(h, w, chroma):
    """One call pads the picture's planes: views with a row pitch into
    larger planes, as the pipeline gives them, odd sizes too."""
    rng = np.random.default_rng(h * w)
    big = [rng.integers(0, 1024, size=s).astype(np.int16)
           for s in ((110, 171), (60, 91), (60, 91))]
    cut = ((slice(3, 99), slice(5, 165)), (slice(2, 50), slice(4, 84)),
           (slice(2, 50), slice(4, 84)))
    want = PL._pad_out(*(jnp.asarray(b[c]) for b, c in zip(big, cut)),
                       h, w, chroma, PAD_L)
    got = TR.pad_picture(*(torch.from_numpy(b)[c] for b, c in zip(big, cut)),
                         h, w, chroma)
    for g, wnt in zip(got, want, strict=True):
        assert (g is None) == (wnt is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    assert chroma or want[1] is None


def test_pad_of_strided_view():
    """The pipeline pads a view into the bordered plane (a row pitch)."""
    rng = np.random.default_rng(3)
    big = torch.from_numpy(rng.integers(0, 256, size=(50, 70))
                           .astype(np.int16))
    view = big[5:37, 7:55]
    pic_y, pic_u, pic_v = TR.pad_picture(view, None, None, 30, 40, False)
    assert pic_u is None and pic_v is None
    np.testing.assert_array_equal(
        pic_y.numpy(), np.pad(view.numpy()[:30, :40], PAD_L, mode="edge"))


@pytest.mark.parametrize("chroma", [True, False])
def test_pad_picture_batch_equals_each_frame(chroma):
    """A GOP batch step's areas [G, H, W] into the DPB's planes: each
    frame's pictures equal its own padding."""
    rng = np.random.default_rng(7)
    G, h, w = 3, 40, 56
    areas = [torch.from_numpy(rng.integers(0, 256, size=(G, 48 >> s,
                                                         72 >> s))
                              .astype(np.int16))[:, :, 1:]
             for s in (0, 1, 1)]
    shapes = [(h + 2 * PAD_L, w + 2 * PAD_L)] + [
        ((h >> 1) + 2 * PAD_C, (w >> 1) + 2 * PAD_C)] * 2
    out = tuple(torch.zeros((G,) + s, dtype=torch.int16) for s in shapes)
    if not chroma:
        areas[1:], out = [None, None], (out[0], None, None)
    got = TR.pad_picture(*areas, h, w, chroma, out=out)
    assert all(g is o for g, o in zip(got, out))
    for g in range(G):
        one = TR.pad_picture(*(None if a is None else a[g] for a in areas),
                             h, w, chroma)
        for b, o in zip(got, one):
            assert (b is None) == (o is None)
            if b is not None:
                assert torch.equal(b[g], o)
