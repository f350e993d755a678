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
from xevd_tpu_torch.ops import addb as TA
from xevd_tpu_torch.ops import alf as TL
from xevd_tpu_torch.ops import deblock as TD
from xevd_tpu_torch.ops import intra as TI
from xevd_tpu_torch.ops import intra_main as TIM
from xevd_tpu_torch.ops import itdq as TQ
from xevd_tpu_torch.ops import mc as TM
from xevd_tpu_torch.ops import pack as PK
from xevd_tpu_torch.ops import recon as TR
from xevd_tpu_torch.ops.tables import PAD_C, PAD_L, device_tables

from .torch_helpers import (addb_case, alf_case, compare, deblock_case,
                            eipd_scene, intra_case, intra_wave_case,
                            itdq_case, itdq_size_case, mc_case, mc_frame,
                            mc_shapes, mc_size_case, pad_case, recon_case,
                            recon_pred_case, suco_case)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The first CUDA device; skips the test on a machine without one
    (decided here, at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs the hand-written kernels")
    return torch.device("cuda", 0)


def _check(case, launches=1):
    """The kernel launched `launches` times and equals its plain version
    exactly."""
    n = K.launch_counts[case.name]
    assert compare(case) == 0, case.shape
    assert K.launch_counts[case.name] == n + launches


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("chroma", [True, False])
def test_itdq_kernel_matches_plain(dev, bd, chroma):
    _check(itdq_case(dev, bd, 128, 256, chroma))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("log2", [2, 3, 4, 5, 6])
def test_itdq_kernel_matches_plain_full_range(dev, bd, log2):
    _check(itdq_size_case(dev, bd, log2))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("chroma", [True, False])
def test_itdq_kernel_matches_plain_main(dev, bd, chroma):
    """The Main transforms: iqt DCT-2 and ATS bases on a frame's TUs."""
    _check(itdq_case(dev, bd, 128, 256, chroma, iqt=True))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("trs", [0, 5, 6, 9, 10])
@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_itdq_kernel_matches_plain_main_full_range(dev, bd, trs, log2):
    """iqt (trs 0) and every ATS basis pair, coefficients over the whole
    int16 range."""
    _check(itdq_size_case(dev, bd, log2, iqt=True, trs=trs))


@pytest.mark.parametrize("bd", [8, 10])
def test_recon_pad_kernels_match_plain(dev, bd):
    _check(recon_case(dev, bd, 1296, 2128))
    _check(pad_case(dev, bd, 1080, 1920, PAD_L))
    _check(pad_case(dev, bd, 540, 960, PAD_C))


@pytest.mark.parametrize("bd", [8, 10])
def test_recon_kernel_with_prediction_matches_plain(dev, bd):
    _check(recon_pred_case(dev, bd, 1296, 2128))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("is_luma", [True, False])
@pytest.mark.parametrize("case", [0, 1, 2, 3])
def test_mc_kernel_matches_plain_by_case(dev, case, is_luma, bd):
    """One launch for each reference list."""
    _check(mc_size_case(dev, is_luma, case, bd), launches=2)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("is_luma", [True, False])
@pytest.mark.parametrize("case", [0, 1, 2, 3])
def test_mc_kernel_matches_plain_main_taps(dev, case, is_luma, bd):
    _check(mc_size_case(dev, is_luma, case, bd, main_taps=True), launches=2)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("chroma", [True, False])
def test_mc_kernel_matches_plain_on_frame(dev, bd, chroma):
    _check(mc_case(dev, 288, 352, bd, chroma, seed=bd), launches=2)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("chroma", [True, False])
def test_intra_kernel_matches_plain(dev, bd, chroma):
    _check(intra_case(dev, 288, 352, bd, chroma, seed=bd))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("chroma,htdf", [(True, True), (False, True),
                                         (True, False)])
def test_intra_wave_kernel_matches_plain(dev, bd, chroma, htdf):
    """One call of the wrapper: its C entry point walks every level."""
    _check(intra_wave_case(dev, 288, 352, bd, chroma, seed=bd, htdf=htdf))


@pytest.mark.parametrize("kind", ["luma_ver", "luma_hor", "chroma_ver",
                                  "chroma_hor"])
@pytest.mark.parametrize("bd", [8, 10])
def test_deblock_kernel_matches_plain(dev, kind, bd):
    """On the 1080p SCU grid."""
    _check(deblock_case(dev, kind, bd, 270, 480))


@pytest.mark.parametrize("bd", [8, 10])
def test_chroma_ver_ordered_kernel_matches_plain(dev, bd):
    """The SUCO-order chroma edges on the 1080p chroma SCU grid."""
    _check(suco_case(dev, bd, 270, 480, seed=bd))


@pytest.mark.parametrize("kind,cb", [("luma_ver", 1), ("luma_hor", 1),
                                     ("chroma_ver", 1), ("chroma_ver", 4),
                                     ("chroma_hor", 1), ("chroma_hor", 4)])
@pytest.mark.parametrize("bd", [8, 10])
def test_addb_kernel_matches_plain(dev, kind, cb, bd):
    H, W = (272, 480) if kind.startswith("luma") else (136, 240)
    _check(addb_case(dev, kind, bd, H, W, seed=bd, cb=cb))


@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("log2_ctu,h,w,across", [
    (6, 288, 352, 1), (6, 272, 360, 0), (7, 264, 392, 1), (7, 264, 392, 0)])
def test_alf_kernel_matches_plain(dev, luma, bd, log2_ctu, h, w, across):
    """CTU 64 and 128, partial CTUs at the right and bottom, across tiles
    or not, random CTU flags (luma)."""
    _check(alf_case(dev, luma, bd, h, w, log2_ctu, across, seed=bd))


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
    tus = torch.tensor([[0, 2, 2, 16, 0, 0, 0]], dtype=torch.int32)
    coef = torch.zeros(8, 8, dtype=torch.int16, device=dev)
    with pytest.raises(ValueError):
        TQ.itdq([coef, None, None], tus, (216, 216), None, 8,
                device_tables(dev))
    fs, job, refp = mc_frame(64, 64, 8, True, seed=3, device=dev)
    table, lists, refs = PK.pack_mc(fs, job, refp, True)
    shp_y, shp_c = mc_shapes(fs, True)
    with pytest.raises(ValueError):       # the block table on the CPU
        TM.mc_all(torch.from_numpy(table), lists, refs, shp_y, shp_c, 8,
                  device_tables(dev))
    with pytest.raises(ValueError):       # the tap tables on the CPU
        TM.mc_all(torch.from_numpy(table).to(dev), lists, refs, shp_y, shp_c,
                  8, device_tables("cpu"))
    recs, res, icu, level_off, _, _ = eipd_scene(64, 64, 8, 1)
    cu_planes = [torch.from_numpy(p).to(dev) for p in recs]
    cu_res = [torch.from_numpy(p).to(dev) for p in res]
    with pytest.raises(ValueError):       # the CU table on the CPU
        TIM.intra_scan_wave(cu_planes, cu_res, torch.from_numpy(icu),
                            level_off, 8, True, device_tables(dev))
    with pytest.raises(ValueError):       # a residual plane on the CPU
        TIM.intra_scan_wave(cu_planes, cu_res[:2] + [torch.from_numpy(res[2])],
                            torch.from_numpy(icu).to(dev), level_off, 8, True,
                            device_tables(dev))
    with pytest.raises(ValueError):       # the EIPD tables on the CPU
        TIM.intra_scan_wave(cu_planes, cu_res, torch.from_numpy(icu).to(dev),
                            level_off, 8, True, device_tables("cpu"))
    with pytest.raises(ValueError):       # the TU table on the CPU (Main)
        TQ.itdq([coef, None, None], torch.zeros(1, 7, dtype=torch.int32),
                (216, 216), None, 8, device_tables(dev), True)
    resid = torch.zeros(8, 8, dtype=torch.int16, device=dev)
    with pytest.raises(ValueError):       # the prediction on the CPU
        TR.recon(resid, 8, torch.zeros(8, 8, dtype=torch.int32),
                 torch.zeros(8, 8, dtype=torch.int8, device=dev))
    u = torch.zeros(16, 32, dtype=torch.int16, device=dev)
    with pytest.raises(ValueError):       # the SUCO edge table on the CPU
        TD.chroma_ver_ordered(u, u.clone(), torch.zeros(9, dtype=torch.int32),
                              torch.zeros(0, 3, dtype=torch.int32), 8)
    with pytest.raises(ValueError):       # the ADDB map on the CPU
        TA.addb_pass("luma_ver", area, torch.zeros(4, 8, 4, dtype=torch.int32),
                     8)
    with pytest.raises(ValueError):       # the ALF coefficients on the CPU
        TL.alf_plane(area, torch.zeros(25, 13, dtype=torch.int32),
                     torch.ones(1, dtype=torch.int32, device=dev), 16, 32, 6,
                     8, True, True)
