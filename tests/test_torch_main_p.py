"""The PyTorch port's Main-profile low-delay P slice end to end, on the CPU:
`m_off_p`, `m_eipd_p`, `m_btt_p`, tuples of tests/test_main_profile.py
CASES (none has SUCO, ADDB or ALF), each decoded by the torch backend
(plain PyTorch versions), the JAX backend and the numpy oracle backend;
the written 10-bit YUV must be equal byte for byte. The Main gate cases
are spread over several files so that the workers of a parallel run
(--dist loadfile) share the JAX backend's compile time."""
import pytest

from .test_torch_slice import assert_backends_agree

CASES = [
    # name, w, h, frames, qp, seed, gop, tools
    ("m_off_p", 176, 144, 3, 33, 102, "IPPP", ()),
    ("m_eipd_p", 176, 144, 3, 32, 105, "IPPP", ("eipd",)),
    ("m_btt_p", 176, 144, 3, 31, 107, "IPPP", ("btt", "eipd", "cm_init")),
]


@pytest.mark.parametrize("name,w,h,n,qp,seed,gop,tools", CASES)
def test_torch_main_ippp_equals_jax_and_numpy(
        fixtures_dir, tmp_path, name, w, h, n, qp, seed, gop, tools):
    assert_backends_agree(fixtures_dir, tmp_path, f"main_{name}", w, h, n, qp,
                          seed, gop, 8, profile=1, tools=tools)
