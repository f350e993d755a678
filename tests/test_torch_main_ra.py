"""The PyTorch port's Main-profile random-access slice (B pictures, both
lists) end to end, on the CPU: `m_off_ra`, `m_admvp_ra`, tuples of
tests/test_main_profile.py CASES (none has SUCO, ADDB or ALF), each
decoded by the torch backend (plain PyTorch versions), the JAX backend and
the numpy oracle backend; the written 10-bit YUV must be equal byte for
byte. The Main gate cases are spread over several files so that the
workers of a parallel run (--dist loadfile) share the JAX backend's
compile time."""
import pytest

from .test_torch_slice import assert_backends_agree

CASES = [
    # name, w, h, frames, qp, seed, gop, tools
    ("m_off_ra", 176, 144, 5, 30, 103, "RA", ()),
    ("m_admvp_ra", 176, 144, 5, 30, 113, "RA",
     ("admvp", "hmvp", "cm_init", "eipd")),
]


@pytest.mark.parametrize("name,w,h,n,qp,seed,gop,tools", CASES)
def test_torch_main_ra_equals_jax_and_numpy(
        fixtures_dir, tmp_path, name, w, h, n, qp, seed, gop, tools):
    assert_backends_agree(fixtures_dir, tmp_path, f"main_{name}", w, h, n, qp,
                          seed, gop, 8, profile=1, tools=tools)
