"""The PyTorch port's Main-profile intra slice end to end, on the CPU:
`m_off_i`, `m_eipd_i`, `m_btt_i`, `m_adcc_i`, tuples of
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
    ("m_off_i", 176, 144, 2, 30, 101, "I", ()),
    ("m_eipd_i", 176, 144, 2, 30, 104, "I", ("eipd",)),
    ("m_btt_i", 176, 144, 2, 30, 106, "I", ("btt", "eipd", "cm_init")),
    ("m_adcc_i", 176, 144, 2, 30, 110, "I", ("adcc", "cm_init", "eipd")),
]


@pytest.mark.parametrize("name,w,h,n,qp,seed,gop,tools", CASES)
def test_torch_main_intra_equals_jax_and_numpy(
        fixtures_dir, tmp_path, name, w, h, n, qp, seed, gop, tools):
    assert_backends_agree(fixtures_dir, tmp_path, f"main_{name}", w, h, n, qp,
                          seed, gop, 8, profile=1, tools=tools)
