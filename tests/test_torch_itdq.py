"""ITDQ of the PyTorch port against the JAX package (exact: integer).
The CUDA kernel is held to the plain version in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xevd_tpu.ops import jax_itdq as JQ
from xevd_tpu.ops import pipeline as PL
from xevd_tpu.ops import ref_numpy as RN
from xevd_tpu_torch.kernels import build as K
from xevd_tpu_torch.ops import itdq as TQ
from xevd_tpu_torch.ops.tables import device_tables

from .torch_helpers import itdq_frame

CPU = torch.device("cpu")


def _blocks(log2, bd, n=9):
    rng = np.random.default_rng(log2 * 100 + bd)
    size = 1 << log2
    coef = rng.integers(-2000, 2000, size=(n, size, size)).astype(np.int32)
    coef[0, 0, 0] = 32767
    coef[1, 0, 0] = -32768
    coef[2] = rng.integers(-32768, 32768, size=(size, size))
    qps = rng.integers(0, 52 + 6 * (bd - 8), size=n)
    scales = np.array([RN.qp_scale(int(q)) for q in qps], np.int32)
    return coef, scales


@pytest.mark.parametrize("log2", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("bd", [8, 10])
def test_itdq_blocks_match_jax(log2, bd):
    coef, scales = _blocks(log2, bd)
    want = np.asarray(JQ.itdq_bucket(jnp.asarray(coef), jnp.asarray(scales),
                                     log2, log2, bd))
    got = TQ.itdq_blocks_ref(torch.from_numpy(coef), torch.from_numpy(scales),
                             log2, log2, bd, device_tables(CPU))
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_itdq_all(coefs, tus, shp_y, shp_c, bd):
    pk = PL._Packer()
    keys = sorted({(int(r[1]), int(r[2]), int(r[0])) for r in tus})
    for lw, lh, comp in keys:
        sel = tus[(tus[:, 1] == lw) & (tus[:, 2] == lh) & (tus[:, 0] == comp)]
        pk.add(f"q_{lw}_{lh}_{comp}_0", sel[:, 3:6])
    payload, sig = pk.finish()
    jc = tuple(jnp.asarray(c) for c in coefs) if shp_c else \
        (jnp.asarray(coefs[0]), jnp.zeros((8, 8), jnp.int16),
         jnp.zeros((8, 8), jnp.int16))
    out = PL._itdq_all(jnp.asarray(payload), jc, sig, shp_y, shp_c, bd)
    return [None if o is None else np.asarray(o) for o in out]


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("chroma", [True, False])
def test_itdq_frame_matches_jax_itdq_all(bd, chroma):
    coefs, tus, shp_y, shp_c = itdq_frame(bd, chroma=chroma)
    want = _jax_itdq_all(coefs, tus, shp_y, shp_c, bd)
    tc = [torch.from_numpy(c) for c in coefs] + [None] * (3 - len(coefs))
    got = TQ.itdq(tc, torch.from_numpy(tus), shp_y, shp_c, bd,
                  device_tables(CPU))
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), w)


def test_itdq_plain_path_launches_nothing():
    coefs, tus, shp_y, shp_c = itdq_frame(8, h=64, w=64)
    before = dict(K.launch_counts)
    TQ.itdq([torch.from_numpy(c) for c in coefs], torch.from_numpy(tus),
            shp_y, shp_c, 8, device_tables(CPU))
    assert K.launch_counts == before


def test_itdq_refuses_main_variants():
    coefs, tus, shp_y, shp_c = itdq_frame(8, h=64, w=64)
    args = ([torch.from_numpy(c) for c in coefs], torch.from_numpy(tus),
            shp_y, shp_c, 8, device_tables(CPU))
    with pytest.raises(NotImplementedError):
        TQ.itdq(*args, iqt=True)
    with pytest.raises(NotImplementedError):
        TQ.itdq(*args, trs=5)
