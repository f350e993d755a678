"""Every hand-written kernel of xevd_tpu_torch against its plain PyTorch
version, on the GPU (exact: integer kernels).  The cases are those of
tests/torch_helpers.py, which chip_smoke.py runs at the 1080p shapes.

Marked `cuda`; each test skips without a CUDA device.  This file imports
no JAX, so it also runs on a GPU machine without JAX, where conftest.py
(which imports JAX) cannot load:

    python -m pytest --noconftest -p no:cacheprovider -o "markers=cuda" \
        tests/test_torch_cuda.py -q
"""
import pytest
import torch

from xevd_tpu_torch.kernels import build as K
from xevd_tpu_torch.ops import deblock as TD
from xevd_tpu_torch.ops import intra as TI
from xevd_tpu_torch.ops import itdq as TQ
from xevd_tpu_torch.ops.tables import PAD_C, PAD_L, device_tables

from .torch_helpers import (compare, deblock_case, intra_case, itdq_case,
                            itdq_size_case, pad_case, recon_case)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The first CUDA device; skips the test on a machine without one
    (decided here, at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs the hand-written kernels")
    return torch.device("cuda", 0)


def _check(case):
    """The kernel launched once and equals its plain version exactly."""
    n = K.launch_counts[case.name]
    assert compare(case) == 0, case.shape
    assert K.launch_counts[case.name] == n + 1


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("chroma", [True, False])
def test_itdq_kernel_matches_plain(dev, bd, chroma):
    _check(itdq_case(dev, bd, 128, 256, chroma))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("log2", [2, 3, 4, 5, 6])
def test_itdq_kernel_matches_plain_full_range(dev, bd, log2):
    _check(itdq_size_case(dev, bd, log2))


@pytest.mark.parametrize("bd", [8, 10])
def test_recon_pad_kernels_match_plain(dev, bd):
    _check(recon_case(dev, bd, 1296, 2128))
    _check(pad_case(dev, bd, 1080, 1920, PAD_L))
    _check(pad_case(dev, bd, 540, 960, PAD_C))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("chroma", [True, False])
def test_intra_kernel_matches_plain(dev, bd, chroma):
    _check(intra_case(dev, 288, 352, bd, chroma, seed=bd))


@pytest.mark.parametrize("kind", ["luma_ver", "luma_hor", "chroma_ver",
                                  "chroma_hor"])
@pytest.mark.parametrize("bd", [8, 10])
def test_deblock_kernel_matches_plain(dev, kind, bd):
    """On the 1080p SCU grid."""
    _check(deblock_case(dev, kind, bd, 270, 480))


def test_wrappers_refuse_cpu_operands_mixed_with_cuda(dev):
    """A CUDA launch checks every operand: a CPU table beside CUDA planes
    raises instead of running the plain version or reading host memory."""
    area = torch.zeros(16, 32, dtype=torch.int16, device=dev)
    with pytest.raises(ValueError):
        TD.deblock_pass("luma_ver", area, torch.zeros(4, 8, dtype=torch.int32),
                        8)
    planes = [torch.zeros(256, 256, dtype=torch.int16, device=dev)
              for _ in range(3)]
    icu = torch.tensor([[0, 0, 3, 0, -1, -1, 1, 1]], dtype=torch.int32)
    with pytest.raises(ValueError):
        TI.intra_scan(planes, planes, icu, 8, True)
    tus = torch.tensor([[0, 2, 2, 16, 0, 0]], dtype=torch.int32)
    coef = torch.zeros(8, 8, dtype=torch.int16, device=dev)
    with pytest.raises(ValueError):
        TQ.itdq([coef, None, None], tus, (216, 216), None, 8,
                device_tables(dev))
