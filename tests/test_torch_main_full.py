"""The PyTorch port's full Main toolset on the CPU: `m_alf_all` (8 bit)
and `m10_all` (10 bit, with DRA), tuples of tests/test_main_profile.py
CASES and CASES10 with ALF, ADDB, HTDF, SUCO and every inter tool,
decoded by the torch backend (plain PyTorch versions), the JAX backend and
the numpy oracle backend; the written 10-bit YUV must be equal byte for
byte.  A file of its own so that the JAX compiles spread over the workers
of a parallel run (--dist loadfile).  `m_alf_all` is marked `slow`
(minutes of JAX compiles, left out of tier-1): `m10_all` has all of its
tools and DRA."""
import pytest

from .test_torch_slice import assert_backends_agree

CASES = [
    # name, w, h, frames, qp, seed, gop, tools, bit depth
    pytest.param("m_alf_all", 176, 144, 5, 31, 713, "RA",
                 ("alf", "addb", "htdf", "eipd", "cm_init", "iqt", "ats",
                  "admvp", "hmvp", "mmvd", "amvr", "btt", "suco", "adcc"), 8,
                 marks=pytest.mark.slow),
    ("m10_all", 176, 144, 5, 31, 804, "RA",
     ("dra", "alf", "addb", "htdf", "eipd", "cm_init", "iqt", "ats",
      "admvp", "hmvp", "mmvd", "amvr", "btt", "suco", "adcc"), 10),
]


@pytest.mark.parametrize("name,w,h,n,qp,seed,gop,tools,bd", CASES)
def test_torch_main_full_equals_jax_and_numpy(
        fixtures_dir, tmp_path, name, w, h, n, qp, seed, gop, tools, bd):
    assert_backends_agree(fixtures_dir, tmp_path, f"main_{name}", w, h, n, qp,
                          seed, gop, bd, profile=1, tools=tools)
