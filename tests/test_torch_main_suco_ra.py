"""The PyTorch port's SUCO-order chroma deblock (K10) on B pictures, on
the CPU: `m_all_ra`, a tuple of tests/test_main_profile.py CASES (SUCO
with every inter tool, iqt and ATS, no ADDB or ALF), decoded by the torch
backend (plain PyTorch versions), the JAX backend and the numpy oracle
backend; the written 10-bit YUV must be equal byte for byte.  A file of
its own, beside test_torch_main_suco.py, so that the JAX compiles spread
over the workers of a parallel run (--dist loadfile)."""
import pytest

from .test_torch_slice import assert_backends_agree

CASES = [
    # name, w, h, frames, qp, seed, gop, tools
    ("m_all_ra", 176, 144, 5, 31, 119, "RA",
     ("iqt", "ats", "admvp", "hmvp", "mmvd", "amvr", "btt", "suco", "adcc",
      "cm_init", "eipd")),
]


@pytest.mark.parametrize("name,w,h,n,qp,seed,gop,tools", CASES)
def test_torch_main_suco_ra_equals_jax_and_numpy(
        fixtures_dir, tmp_path, name, w, h, n, qp, seed, gop, tools):
    assert_backends_agree(fixtures_dir, tmp_path, f"main_{name}", w, h, n, qp,
                          seed, gop, 8, profile=1, tools=tools)
