"""The PyTorch port's Baseline random-access slice (hierarchical B, both
reference lists and bi-prediction) end to end, on the CPU: the RA gate
cases of ROADMAP M3 (tuples of tests/test_golden.py), each decoded by the
torch backend (plain PyTorch versions), the JAX backend and the numpy
oracle backend; the written 10-bit YUV must be equal byte for byte."""
import pytest

from .test_torch_slice import assert_backends_agree

CASES = [
    # name, w, h, frames, qp, seed, gop, bd
    ("ra64", 64, 64, 9, 30, 9, "RA", 8),
    ("ra176x144", 176, 144, 9, 32, 10, "RA", 8),
    ("ra176_dense", 176, 144, 5, 24, 12, "RA", 8),
    ("ra10_96", 96, 64, 5, 32, 21, "RA", 10),
]


@pytest.mark.parametrize("name,w,h,n,qp,seed,gop,bd", CASES)
def test_torch_ra_equals_jax_and_numpy(fixtures_dir, tmp_path, name, w, h, n,
                                       qp, seed, gop, bd):
    assert_backends_agree(fixtures_dir, tmp_path, name, w, h, n, qp, seed,
                          gop, bd)
