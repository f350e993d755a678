"""The PyTorch port's Baseline low-delay P slice end to end, on the CPU:
the IPPP gate cases of ROADMAP M3 (tuples of tests/test_golden.py), each
decoded by the torch backend (plain PyTorch versions), the JAX backend and
the numpy oracle backend; the written 10-bit YUV must be equal byte for
byte."""
import pytest

from .test_torch_slice import assert_backends_agree

CASES = [
    # name, w, h, frames, qp, seed, gop, bd
    ("p64", 64, 64, 4, 30, 6, "IPPP", 8),
    ("p176x144", 176, 144, 4, 35, 7, "IPPP", 8),
    ("p176x144_qp20", 176, 144, 3, 20, 8, "IPPP", 8),
    ("p10_176", 176, 144, 3, 35, 22, "IPPP", 10),
]


@pytest.mark.parametrize("name,w,h,n,qp,seed,gop,bd", CASES)
def test_torch_ippp_equals_jax_and_numpy(fixtures_dir, tmp_path, name, w, h,
                                         n, qp, seed, gop, bd):
    assert_backends_agree(fixtures_dir, tmp_path, name, w, h, n, qp, seed,
                          gop, bd)
