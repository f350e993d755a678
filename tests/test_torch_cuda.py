"""Every hand-written kernel of xevd_tpu_torch against its plain PyTorch
version, on the GPU (exact: integer kernels).  The cases are those of
tests/torch_helpers.py, which chip_smoke.py runs at the 1080p shapes.

Marked `cuda`; each test skips without a CUDA device.  This file imports
no JAX, so it also runs on a GPU machine without JAX, where conftest.py
(which imports JAX) cannot load:

    python -m pytest --noconftest -p no:cacheprovider -o "markers=cuda" \
        tests/test_torch_cuda.py -q
"""
import sys
from pathlib import Path

import numpy as np
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
from xevd_tpu_torch.ops.tables import PAD_L, device_tables

from .torch_helpers import (CHROMA_MAPS, LUMA_MAPS, SUCO_LISTS,
                            addb_synth_case, alf_synth_case, chroma_map,
                            compare, deblock_case, deblock_luma_case,
                            eipd_scene,
                            gop_step_cases, intra_batch_case, intra_case,
                            intra_chain_case, intra_wave_case,
                            itdq_case, itdq_class_case, itdq_size_case,
                            mc_case, mc_class_case, mc_frame,
                            mc_order_on, mc_shapes, mc_size_case,
                            pad_picture_case, recon_case,
                            recon_pred_case, repeat_equal, suco_case)

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


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("iqt", [False, True])
@pytest.mark.parametrize("bd", [8, 10])
def test_itdq_kernel_class_mix(dev, bd, iqt, extreme):
    """Every size class of the kernel in one launch (2x2 to 64x64, square
    and rectangular; Baseline beside ATS, or all Main), ten launches;
    `extreme`: the largest scale, coefficients over the whole int16 range,
    stage 0 at its int32 bound."""
    _check_repeated(itdq_class_case(dev, bd, iqt, seed=bd, extreme=extreme))


@pytest.mark.parametrize("bd", [8, 10])
def test_recon_pad_kernels_match_plain(dev, bd):
    _check(recon_case(dev, bd, 1296, 2128))
    _check(pad_picture_case(dev, bd, 1080, 1920))


@pytest.mark.parametrize("h,w,chroma,G,unaligned", [
    (1080, 1920, True, None, False), (1080, 1920, True, None, True),
    (1080, 1920, False, None, False), (1080, 1920, True, 8, False),
    (1080, 1920, True, 1, False), (144, 176, True, 8, True),
    (90, 150, True, None, False)])
@pytest.mark.parametrize("bd", [8, 10])
def test_pad_picture_kernel_matches_plain(dev, bd, h, w, chroma, G,
                                          unaligned):
    """K14, one launch a picture over Y, U and V: a config-3-sized
    picture, planes with an odd pitch (scalar loads), 4:0:0, a GOP batch
    step of 8 and of 1 picture, and an output width that is not a multiple
    of 8 (scalar stores)."""
    _check(pad_picture_case(dev, bd, h, w, chroma, G, unaligned, seed=bd))


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


@pytest.mark.parametrize("main_taps", [False, True])
@pytest.mark.parametrize("bd", [8, 10])
def test_mc_kernel_class_mix(dev, bd, main_taps):
    """Every class of the kernel in each list's launch (every plane group,
    size and case; windows at the reference planes' edges, phase 0 under
    filtering cases, full-range samples; 64x64 blocks split over 128
    threads), ten calls of two launches, each equal to the plain version's
    one result."""
    case = mc_class_case(dev, bd, main_taps, seed=bd)
    n = K.launch_counts["mc"]
    assert repeat_equal(case, case.plain(), 10) == 0, case.shape
    assert K.launch_counts["mc"] == n + 20


def _check_repeated(case, launches=10):
    """A persistent scan: each of `launches` runs from the same inputs
    equals the plain version's one result (a race between CTAs shows as a
    difference between runs), one launch a run."""
    n = K.launch_counts[case.name]
    assert repeat_equal(case, case.plain(), launches) == 0, case.shape
    assert K.launch_counts[case.name] == n + launches


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("chroma", [True, False])
def test_intra_kernel_matches_plain(dev, bd, chroma):
    """Causal random masks over CIF, ten launches."""
    _check_repeated(intra_case(dev, 288, 352, bd, chroma, seed=bd))


@pytest.mark.parametrize("G", [1, 3, 8])
def test_intra_kernel_batched_matches_plain(dev, G):
    """The GOP batch's launch (icu_off) over G causal CIF scenes, its rows
    taken in the pack's ticket order (ops/pack.py `icu_order`), against
    the frame-after-frame plain version."""
    _check_repeated(intra_batch_case(dev, G, 288, 352, 8, seed=40))


def test_intra_kernel_batched_refuses_a_missing_order(dev):
    """A batched launch without the ticket order raises (no launch)."""
    case = intra_batch_case(dev, 2, 64, 64, 8, seed=3)
    planes = [torch.zeros(2, 160, 160, dtype=torch.int16, device=dev)
              for _ in range(3)]
    icu = torch.zeros(4, 8, dtype=torch.int32, device=dev)
    off = torch.tensor([0, 2, 4], dtype=torch.int32, device=dev)
    n = K.launch_counts["intra_scan"]
    with pytest.raises(ValueError, match="ticket order"):
        TI.intra_scan(planes, planes, icu, 8, True, icu_off=off)
    assert K.launch_counts["intra_scan"] == n
    assert compare(case) == 0


def test_intra_kernel_4x4_chain_matches_plain(dev):
    """The longest chains: 4x4 CUs, every causal bit set."""
    _check_repeated(intra_chain_case(dev, 128, 192, 10, seed=2))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("chroma,htdf", [(True, True), (False, True),
                                         (True, False)])
def test_intra_wave_kernel_matches_plain(dev, bd, chroma, htdf):
    """One launch a call walks every level, ten calls."""
    _check_repeated(intra_wave_case(dev, 288, 352, bd, chroma, seed=bd,
                                    htdf=htdf))


@pytest.mark.parametrize("kind", ["luma_ver", "luma_hor", "chroma_ver",
                                  "chroma_hor"])
@pytest.mark.parametrize("bd", [8, 10])
def test_deblock_kernel_matches_plain(dev, kind, bd):
    """On the 1080p SCU grid."""
    _check(deblock_case(dev, kind, bd, 270, 480))


@pytest.mark.parametrize("maps", LUMA_MAPS)
@pytest.mark.parametrize("bd", [8, 10])
def test_deblock_luma_kernel_map_kinds(dev, bd, maps):
    """K8, both luma passes in one launch, on a 1080p area with smooth
    samples against `luma_blocks_ref`: random maps, every edge at the
    largest strength, no edge, vertical or horizontal edges only; twenty
    launches from the same inputs."""
    _check_repeated(deblock_luma_case(dev, bd, 270, 480, seed=bd, maps=maps),
                    launches=20)


@pytest.mark.parametrize("bd", [8, 10])
def test_deblock_luma_kernel_gop_batch(dev, bd):
    """K8 on a GOP batch of eight 1080p areas, each with maps of its own,
    in one launch; twenty launches."""
    _check_repeated(deblock_luma_case(dev, bd, 270, 480, seed=bd, G=8),
                    launches=20)


def test_deblock_luma_refuses_unaligned_views(dev):
    """The luma kernel reads 32-bit words: an area at an odd column, or on
    a plane with an odd row pitch, raises instead of taking another path;
    a GOP batch with an odd batch stride too."""
    st = torch.zeros(4, 8, dtype=torch.int32, device=dev)
    plane = torch.zeros(24, 48, dtype=torch.int16, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        TD.deblock_luma(plane[2:18, 3:35], st, st, 8)
    odd = torch.zeros(24, 47, dtype=torch.int16, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        TD.deblock_pass("luma_ver", odd[2:18, 2:34], st, 8)
    batch = torch.zeros(2 * (24 * 48 + 1), dtype=torch.int16, device=dev)
    areas = batch.as_strided((2, 16, 32), (24 * 48 + 1, 48, 1), 2 * 48 + 2)
    with pytest.raises(ValueError, match="aligned"):
        TD.deblock_luma(areas, st.expand(2, 4, 8), None, 8)
    n = K.launch_counts["deblock_luma"]
    TD.deblock_luma(plane[2:18, 2:34], st, st, 8)
    assert K.launch_counts["deblock_luma"] == n + 1


@pytest.mark.parametrize("maps", CHROMA_MAPS)
@pytest.mark.parametrize("kind", ["chroma_ver", "chroma_hor"])
@pytest.mark.parametrize("bd", [8, 10])
def test_deblock_chroma_kernel_map_kinds(dev, kind, bd, maps):
    """K9 on the 1080p chroma SCU grid: random maps (short runs), every
    edge with a strength (each line one run: the longest chains) and no
    edge at all; ten launches from the same inputs."""
    rng = np.random.default_rng(bd + len(maps))
    _check_repeated(deblock_case(dev, kind, bd, 270, 480, seed=bd,
                                 st=chroma_map(rng, maps, 270, 480),
                                 label=f" {maps}"))


@pytest.mark.parametrize("bd", [8, 10])
def test_chroma_ver_ordered_kernel_matches_plain(dev, bd):
    """The SUCO-order chroma edges on the 1080p chroma SCU grid."""
    _check(suco_case(dev, bd, 270, 480, seed=bd))


@pytest.mark.parametrize("kind", SUCO_LISTS)
@pytest.mark.parametrize("bd", [8, 10])
def test_chroma_ver_ordered_kernel_list_kinds(dev, bd, kind):
    """K10 on the 1080p chroma SCU grid with every kind of edge list
    (random, every edge on, one long run, repeated edges, empty rows);
    twenty launches from the same inputs (a missing barrier in the
    shared-memory walk shows only as a difference between them)."""
    _check_repeated(suco_case(dev, bd, 270, 480, seed=bd, kind=kind),
                    launches=20)


@pytest.mark.parametrize("maps,chroma,unaligned", [
    ("dense", True, False), ("strong", True, False), ("none", True, False),
    ("dense", False, False), ("dense", True, True)])
@pytest.mark.parametrize("bd", [8, 10])
def test_addb_kernel_matches_plain(dev, maps, chroma, unaligned, bd):
    """The fused ADDB kernel, one launch a picture, on a 272x480 picture:
    random maps, bs 4 everywhere and no edge, 4:2:0 and 4:0:0, and planes
    whose odd pitch takes the sample-by-sample loads; ten launches from
    the same inputs (a barrier race shows as a difference between them)."""
    _check_repeated(addb_synth_case(dev, bd, 272, 480, seed=bd,
                                    chroma=chroma, maps=maps,
                                    unaligned=unaligned))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("log2_ctu,h,w,across,enables,unaligned", [
    (6, 288, 352, 1, (1, 1, 1), False), (6, 272, 360, 0, (1, 1, 1), False),
    (7, 264, 392, 1, (1, 1, 1), False), (7, 264, 392, 0, (1, 0, 1), False),
    (6, 272, 360, 0, (0, 1, 1), False), (6, 272, 360, 1, (1, 0, 0), True)])
def test_alf_kernel_matches_plain(dev, bd, log2_ctu, h, w, across, enables,
                                  unaligned):
    """ALF, one launch a picture: CTU 64 and 128, partial CTUs at the right
    and bottom, across tiles or not, random CTU flags, subsets of the
    planes, and planes whose odd pitch takes the sample-by-sample loads;
    ten launches."""
    _check_repeated(alf_synth_case(dev, bd, h, w, log2_ctu, across, seed=bd,
                                   enables=tuple(map(bool, enables)),
                                   unaligned=unaligned))


@pytest.fixture(scope="module")
def gop_captures():
    """Three IPPP GOPs of 2, 3 and 4 frames at 192x128 (tools/evc_enc with
    xevd_tpu/parallel/gop.py `gen_gop_streams`' settings), captured by the
    port's host decoder."""
    from xevd_tpu_torch.parallel.gop import _capture_gop
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import evc_enc
    return [_capture_gop(evc_enc.encode_stream(
        192, 128, 2 + g, 30, 1000 + 7 * g, "IPPP", 0.5)) for g in range(3)]


@pytest.mark.parametrize("t", [0, 1])
@pytest.mark.parametrize("G", [1, 3])
def test_gop_batched_kernels_match_plain(dev, gop_captures, G, t):
    """K15: every batched kernel, and the whole batched step, on step t of
    a batch of G GOPs (its own tables and DPB; step 0 the I pictures, no
    MC), one launch each."""
    for case in gop_step_cases(dev, gop_captures[:G], t=t):
        _check(case)


@pytest.mark.parametrize("t", [0, 1])
@pytest.mark.parametrize("G", [1, 3])
def test_gop_intra_scan_repeated(dev, gop_captures, G, t):
    """The batched intra scan on step t of the GOP batch, ten launches."""
    case, = (c for c in gop_step_cases(dev, gop_captures[:G], t=t)
             if c.name == "intra_scan")
    _check_repeated(case)


@pytest.fixture(scope="module")
def main_gop_captures():
    """Three Main IPPP GOPs of 2, 3 and 4 frames at 192x128 with iqt, ATS,
    ADMVP (the Main MC taps) and cm_init, captured by the port's host
    decoder with the serial oracle's planes."""
    from xevd_tpu_torch.parallel.gop import _capture_gop
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import evc_enc
    tools = evc_enc.Tools(iqt=1, ats=1, admvp=1, cm_init=1)
    return [_capture_gop(evc_enc.encode_stream(
        192, 128, 2 + g, 30, 1100 + 7 * g, "IPPP", 0.5, profile=1,
        tools=tools), oracle=True) for g in range(3)]


@pytest.mark.parametrize("G", [1, 3])
def test_gop_batched_kernels_match_plain_main_taps(dev, main_gop_captures,
                                                   G):
    """K15 on Main GOPs: the batched iqt/ATS ITDQ and Main-tap MC, and
    every other batched kernel and the step, on step 1 of G GOPs; the
    whole batch equal to the serial oracle frame by frame."""
    from xevd_tpu_torch.parallel import gop as TG
    cases = gop_step_cases(dev, main_gop_captures[:G])
    assert main_gop_captures[0][1]["pack"].main_taps
    for case in cases:
        _check(case)
    dmd5, smd5 = TG.decode_gops_sharded(None, mesh=[dev],
                                        captures=main_gop_captures[:G])
    assert dmd5 == smd5


@pytest.fixture(scope="module")
def forty_gop_captures():
    """Forty two-frame 64x64 IPPP GOPs (D x G_dev = 40 DPB pictures on one
    card), captured by the port's host decoder with the serial oracle's
    planes."""
    from xevd_tpu_torch.parallel.gop import _capture_gop
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import evc_enc
    return [_capture_gop(evc_enc.encode_stream(
        64, 64, 2, 30, 2000 + 7 * g, "IPPP", 0.5), oracle=True)
        for g in range(40)]


def test_gop_batch_beyond_32_ring_slots(dev, forty_gop_captures):
    """Batched MC reads the DPB ring by its strides: with 40 ring pictures
    (more than a frame's 32-slot pointer table) every batched kernel and
    the step equal their plain versions, MC in ten launches, and the whole
    batch equals the serial oracle frame by frame."""
    from xevd_tpu_torch.parallel import gop as TG
    cases = gop_step_cases(dev, forty_gop_captures)
    for case in cases:
        _check(case)
    mc, = (c for c in cases if c.name == "mc")
    _check_repeated(mc, launches=10)
    stats = {}
    dmd5, smd5 = TG.decode_gops_sharded(None, mesh=[dev], stats=stats,
                                        captures=forty_gop_captures)
    assert stats["depth"] * 40 > PK.MAX_REF_SLOTS
    assert dmd5 == smd5
    assert stats["checksum"] == stats["serial_checksum"]


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
    order = mc_order_on(dev, table, lists)
    with pytest.raises(ValueError):       # the block table on the CPU
        TM.mc_all(torch.from_numpy(table), lists, refs, shp_y, shp_c, 8,
                  device_tables(dev), order=order)
    with pytest.raises(ValueError):       # the tap tables on the CPU
        TM.mc_all(torch.from_numpy(table).to(dev), lists, refs, shp_y, shp_c,
                  8, device_tables("cpu"), order=order)
    with pytest.raises(ValueError):       # the class order on the CPU
        TM.mc_all(torch.from_numpy(table).to(dev), lists, refs, shp_y, shp_c,
                  8, device_tables(dev), order=mc_order_on("cpu", table,
                                                           lists))
    with pytest.raises(ValueError, match="class order"):   # no class order
        TM.mc_all(torch.from_numpy(table).to(dev), lists, refs, shp_y, shp_c,
                  8, device_tables(dev))
    recs, res, icu, level_off, _, _ = eipd_scene(64, 64, 8, 1)
    cu_planes = [torch.from_numpy(p).to(dev) for p in recs]
    cu_res = [torch.from_numpy(p).to(dev) for p in res]
    offs = torch.from_numpy(level_off).to(dev)
    with pytest.raises(ValueError):       # the CU table on the CPU
        TIM.intra_scan_wave(cu_planes, cu_res, torch.from_numpy(icu), offs,
                            8, True, device_tables(dev))
    with pytest.raises(ValueError):       # a residual plane on the CPU
        TIM.intra_scan_wave(cu_planes, cu_res[:2] + [torch.from_numpy(res[2])],
                            torch.from_numpy(icu).to(dev), offs, 8, True,
                            device_tables(dev))
    with pytest.raises(ValueError):       # the EIPD tables on the CPU
        TIM.intra_scan_wave(cu_planes, cu_res, torch.from_numpy(icu).to(dev),
                            offs, 8, True, device_tables("cpu"))
    for host in (level_off, torch.from_numpy(level_off)):
        with pytest.raises(ValueError):   # the level offsets on the host
            TIM.intra_scan_wave(cu_planes, cu_res,
                                torch.from_numpy(icu).to(dev), host, 8, True,
                                device_tables(dev))
    with pytest.raises(ValueError):       # no class order (ops/pack.py)
        TQ.itdq([coef, None, None], tus.to(dev), (216, 216), None, 8,
                device_tables(dev))
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
    off = torch.zeros(9, dtype=torch.int32, device=dev)
    edges = torch.zeros(0, 3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="run table"):    # no run table
        TD.chroma_ver_ordered(u, u.clone(), off, edges, 8)
    runs = PK.suco_runs(np.zeros(9, np.int32), np.zeros((0, 3), np.int32))
    with pytest.raises(ValueError):       # the run table on the host
        TD.chroma_ver_ordered(u, u.clone(), off, edges, 8, runs=runs)
    with pytest.raises(ValueError):       # a pad output plane on the CPU
        TR.pad_picture(area, None, None, 8, 16, False,
                       out=(torch.zeros(8 + 2 * PAD_L, 16 + 2 * PAD_L,
                                        dtype=torch.int16), None, None))
    maps = [torch.zeros(2, 4, 8, n, dtype=torch.int32) for n in (4, 7)]
    uv = [torch.zeros(8, 16, dtype=torch.int16, device=dev) for _ in range(2)]
    with pytest.raises(ValueError):       # the ADDB maps on the CPU
        TA.addb_frame(area, *uv, *maps, 8)
    with pytest.raises(ValueError):       # the chroma map on the CPU
        TA.addb_frame(area, *uv, maps[0].to(dev), maps[1], 8)
    with pytest.raises(ValueError):       # no per-pass kernel
        TA.addb_pass("luma_ver", area, maps[0][0].to(dev), 8)
    on = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):       # the ALF coefficients on the CPU
        TL.alf_frame(area, *uv, torch.zeros(25, 13, dtype=torch.int32),
                     torch.zeros(7, dtype=torch.int32, device=dev), on, 16,
                     32, ((True, True, True), 6, True), 8)
    with pytest.raises(ValueError):       # the CTU flags on the CPU
        TL.alf_frame(area, *uv, torch.zeros(25, 13, dtype=torch.int32,
                                            device=dev),
                     torch.zeros(7, dtype=torch.int32, device=dev), on.cpu(),
                     16, 32, ((True, False, False), 6, True), 8)


@pytest.fixture(scope="module")
def staging_streams():
    """Two 176x144 streams (tools/evc_enc): Baseline IPPP (4 frames) and
    Main RA with SUCO, ADDB, ALF and the config-3 tools (5 pictures)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import evc_enc
    tools = evc_enc.Tools(**{k: 1 for k in (
        "alf", "addb", "htdf", "eipd", "cm_init", "iqt", "ats", "admvp",
        "hmvp", "mmvd", "amvr", "btt", "suco", "adcc")})
    return {"ippp": evc_enc.encode_stream(176, 144, 4, 35, 7, "IPPP", 0.5),
            "main": evc_enc.encode_stream(176, 144, 5, 31, 713, "RA", 0.5,
                                          profile=1, tools=tools)}


def _frame_md5s(data, backend):
    from xevd_tpu_torch import bench as B
    return [B.frame_md5(f) for f in B.decode(data, backend)[0]]


def test_staging_slots_are_pinned(dev):
    """A staging slot's buffers are pinned, also once grown; the upload
    from a slot copies without blocking and records the slot's event; a
    slot whose buffer is not pinned raises at the upload."""
    from xevd_tpu_torch.ops.staging import HostStaging
    ring = HostStaging(dev, 2)
    slot = ring.acquire(payload_words=1 << 20, coef_count=1 << 20)
    for s in ring.slots:
        assert s.payload.is_pinned() and s.coefs.is_pinned()
    assert slot.payload.numel() >= 1 << 20
    slot.payload_np[:6] = np.arange(6)
    slot.coefs_np[:4] = -np.arange(4)
    payload, coefs = PK._copies(slot.payload_np[:6], slot.coefs_np[:4], slot,
                                dev)
    slot.event.synchronize()
    assert payload.is_cuda and payload.cpu().tolist() == list(range(6))
    assert coefs.cpu().tolist() == [0, -1, -2, -3]
    slot.payload = torch.zeros(6, dtype=torch.int32)    # pageable
    with pytest.raises(RuntimeError, match="not pinned"):
        PK._copies(slot.payload_np[:6], slot.coefs_np[:4], slot, dev)


@pytest.mark.parametrize("key", ["ippp", "main"])
def test_decode_frame_never_synchronises(dev, staging_streams, key):
    """Under torch.cuda.set_sync_debug_mode("error") around each
    `decode_frame` (not around the reads), a decode on the card raises on
    no synchronising call and equals the plain versions' decode."""
    from xevd_tpu_torch import TorchPixelBackend

    class NoSync(TorchPixelBackend):
        def decode_frame(self, job, sps, refp):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return super().decode_frame(job, sps, refp)
            finally:
                torch.cuda.set_sync_debug_mode("default")

    data = staging_streams[key]
    want = _frame_md5s(data, TorchPixelBackend("cpu"))
    assert _frame_md5s(data, TorchPixelBackend(dev)) == want   # warm-up
    assert _frame_md5s(data, NoSync(dev)) == want


@pytest.mark.parametrize("key", ["ippp", "main"])
def test_ring_under_pressure_equals_plain(dev, staging_streams, key):
    """A ring of 2 slots with a long torch.cuda._sleep on the stream before
    each frame's copies: the pack two frames later finds its slot's
    copies queued and waits on the slot's event; the decode equals the
    plain versions' decode."""
    from xevd_tpu_torch import TorchPixelBackend

    def sleep_before_copies(stage):
        if stage == "pack":
            torch.cuda._sleep(200_000_000)

    data = staging_streams[key]
    backend = TorchPixelBackend(dev, on_stage=sleep_before_copies)
    assert _frame_md5s(data, backend) == _frame_md5s(
        data, TorchPixelBackend("cpu"))
    assert backend.staging.waits > 0


def test_entry_step_equals_plain(dev):
    """The graft entry's step on the card (ITDQ, recon and K8 kernels, one
    launch each) equals its plain versions' on the CPU, byte for byte."""
    from xevd_tpu_torch.entry import entry
    fn, args = entry(str(dev))
    before = {k: K.launch_counts[k] for k in ("itdq", "recon",
                                              "deblock_luma")}
    got = fn(*args).cpu()
    assert {k: K.launch_counts[k] - n for k, n in before.items()} == {
        "itdq": 1, "recon": 1, "deblock_luma": 1}
    fn_c, args_c = entry("cpu")
    assert torch.equal(got, fn_c(*args_c))
