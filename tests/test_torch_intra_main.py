"""The EIPD wavefront intra scan with HTDF of the PyTorch port (K6, K7)
against the JAX package (`intra_scan_wave`, `_htdf_tile`, `_predict_main`,
`_nbr_main`, `_fill_dir`; exact: integer), and the order of its CUDA scan
(each CU's HTDF right after its own prediction, a level's CUs in any
order) against JAX's level scan.  The CUDA kernel is held to the plain
version in test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xevd_tpu.ops import jax_intra_main as JIM
from xevd_tpu.ops import pipeline as PL
from xevd_tpu.ops.wavefront import group_wavefront
from xevd_tpu_torch.kernels import build as K
from xevd_tpu_torch.ops import intra_main as TIM
from xevd_tpu_torch.ops import pack as PK

from .conftest import make_stream
from .torch_helpers import (bordered, captured_frames, eipd_scene,
                            planes_before_intra)

CPU = torch.device("cpu")


@pytest.mark.parametrize("lg", [1, 2])
def test_fill_dir_matches_jax(lg):
    """Random masks (some with only low units set) and seeds."""
    rng = np.random.default_rng(lg)
    for n in (8, 16, 32, 64, 128):
        if n >> lg > 32:
            continue
        for _ in range(8):
            raw = rng.integers(0, 1024, n).astype(np.int32)
            mask = int(rng.integers(0, 2 ** 32))
            if rng.random() < 0.4:
                mask &= int(rng.integers(0, 256))
            seed = int(rng.integers(0, 1024))
            want = np.asarray(JIM._fill_dir(jnp.asarray(raw), jnp.uint32(mask),
                                            lg, jnp.int32(seed), n))
            got = TIM.fill_dir_ref(torch.from_numpy(raw), mask, lg, seed)
            np.testing.assert_array_equal(got.numpy(), want)


_predict = jax.jit(JIM._predict_main, static_argnums=(10, 11))
_nbr = jax.jit(JIM._nbr_main, static_argnums=(9, 10, 11))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("lw,lh", [(2, 2), (6, 6), (2, 4), (5, 3), (3, 6),
                                   (1, 1), (1, 3), (4, 2)])
def test_neighbours_and_every_mode_match_jax(lw, lh, bd):
    """nbr_main_ref = `_nbr_main` (the first w + h + 1 samples, the rest
    is unused), and predict_main_ref = `_predict_main` on the CU for all
    33 modes and the four left/right availabilities."""
    rng = np.random.default_rng(100 * lw + 10 * lh + bd)
    S = max(8, 1 << max(lw, lh))
    plane = bordered(rng, 160, 160, 0, 1 << bd)
    lg = 2 if min(lw, lh) >= 2 else 1
    um, lm, rm = (int(rng.integers(0, 2 ** 32)) for _ in range(3))
    co = int(rng.integers(0, 2))
    upg, leg, rig = _nbr(jnp.asarray(plane), 32, 64, lw, lh,
                         *(jnp.uint32(m).astype(jnp.int32)
                           for m in (um, lm, rm)), co, lg, S, bd)
    tu, tl, tr = TIM.nbr_main_ref(torch.from_numpy(plane), 32, 64, lw, lh,
                                  um, lm, rm, co, lg, bd)
    n1 = (1 << lw) + (1 << lh) + 1
    for want, got in ((upg, tu), (leg, tl), (rig, tr)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:n1])
    ii = jax.lax.broadcasted_iota(jnp.int32, (S, S), 1)
    jj = jax.lax.broadcasted_iota(jnp.int32, (S, S), 0)
    for lr in range(4):
        for ipm in range(33):
            want = np.asarray(_predict(upg, leg, rig, upg[1:], ipm, lw, lh,
                                       lr, ii, jj, S, bd))
            got = TIM.predict_main_ref(tu, tl, tr, ipm, lw, lh, lr, bd)
            np.testing.assert_array_equal(
                got.numpy(), want[:1 << lh, :1 << lw],
                err_msg=f"ipm {ipm} lr {lr}")


_htdf = jax.jit(JIM._htdf_tile, static_argnums=(7, 8))


@pytest.mark.parametrize("tbl_idx", [0, 1, 2, 3, 4])
def test_htdf_tile_matches_jax(tbl_idx):
    """Every availability pattern (7 bits) at three CU shapes, on a plane
    whose samples span the range, so every table entry and the pass-through
    above the threshold are hit."""
    rng = np.random.default_rng(tbl_idx)
    for bd, (lw, lh) in ((8, (3, 3)), (10, (4, 2)), (8, (2, 5))):
        plane = bordered(rng, 96, 96, 0, 1 << bd)
        S = max(8, 1 << max(lw, lh))
        for avail in range(128):
            want = np.asarray(_htdf(jnp.asarray(plane), 40, 24, lw, lh,
                                    avail, tbl_idx, S, bd))
            got = TIM.htdf_tile_ref(torch.from_numpy(plane), 40, 24, lw, lh,
                                    avail, tbl_idx, bd)
            np.testing.assert_array_equal(got.numpy(),
                                          want[:1 << lh, :1 << lw],
                                          err_msg=f"avail {avail}")


def _jax_scan(recs, resids, groups, bd, chroma):
    rt = tuple(jnp.asarray(np.asarray(r if r is not None else resids[0]))
               for r in resids)
    planes = tuple(jnp.asarray(np.asarray(r)) if r is not None
                   else jnp.zeros((8, 8), jnp.int16) for r in recs)
    return [np.asarray(p) for p in JIM.intra_scan_wave(planes, rt, groups, bd,
                                                       chroma)]


def _assert_scan_equal(got, want, chroma):
    for i in range(3 if chroma else 1):
        np.testing.assert_array_equal(got[i].numpy(), want[i],
                                      err_msg=f"plane {i}")


@pytest.mark.parametrize("name,w,h,n,qp,seed,gop,tools,bd,pick", [
    # tuples of tests/test_main_profile.py CASES / CASES10
    ("m_eipd_i", 176, 144, 2, 30, 104, "I", ("eipd",), 8, "intra"),
    ("m_btt_p", 176, 144, 3, 31, 107, "IPPP", ("btt", "eipd", "cm_init"), 8,
     "btt"),
    ("m_htdf_p", 176, 144, 4, 27, 602, "IPPP",
     ("htdf", "eipd", "cm_init", "admvp", "hmvp"), 8, "htdf"),
    ("m10_dra_i", 176, 144, 2, 30, 801, "I", ("dra", "eipd", "cm_init"), 10,
     "intra"),
])
def test_intra_scan_wave_ref_matches_jax_on_stream_frame(
        fixtures_dir, name, w, h, n, qp, seed, gop, tools, bd, pick):
    """A real picture's own scan: an intra picture, a BTT P picture with
    rectangular CUs, an HTDF P picture with HTDF-only inter CUs, a 10-bit
    picture.  Both sides start from the planes after ITDQ, MC and recon;
    the JAX side is fed JaxPixelBackend's wavefront groups."""
    stream = make_stream(fixtures_dir / f"torch_wave_{name}.evc", w, h, n, qp,
                         seed, gop, profile=1, tools=tools, bd=bd)
    frames = captured_frames(stream)

    def score(f):
        fs, job, pf = f[0].fs, f[0], f[3]
        if pick == "btt":
            return int((fs.cu_log2w != fs.cu_log2h).sum()) if pf.refs else -1
        if pick == "htdf":
            return (int(((fs.cu_pred_mode != 0) & (job.cu_htdf_idx >= 0))
                        .sum()) if pf.refs else -1)
        return int((fs.cu_pred_mode == 0).sum())
    job, sps, refp, pf = max(frames, key=score)
    assert pf.eipd and pf.bd == bd and score((job, sps, refp, pf)) > 0
    if pick == "htdf":
        assert pf.layout["icu"][1][1] == 16
    recs, resids, df = planes_before_intra(pf, CPU)
    groups = PL.JaxPixelBackend().pack_frame(job, sps, refp)["icu"]
    want = _jax_scan(recs, resids, groups, bd, pf.chroma)
    got = TIM.intra_scan_wave(recs, resids, df.icu, df.level_off, bd,
                              pf.chroma, None)
    _assert_scan_equal(got, want, pf.chroma)


@pytest.mark.parametrize("chroma,htdf", [(False, True), (True, True),
                                         (True, False)])
def test_intra_scan_wave_ref_matches_jax_on_synthetic_frame(chroma, htdf):
    """Random modes, trees, rectangles and HTDF over 128 x 192: the
    luma-only call (chroma False) included; JAX gets the same rows grouped
    by `group_wavefront`."""
    bd = 10 if chroma else 8
    recs, res, icu, level_off, rows, levels = eipd_scene(128, 192, bd, 7,
                                                         chroma, htdf)
    groups = {S: jnp.asarray(a) for S, a in group_wavefront(
        rows, levels, rows[:, 2], rows[:, 3],
        lambda name, v: 1 << (v - 1).bit_length()).items()}
    tr = [torch.from_numpy(p) for p in recs]
    rs = [torch.from_numpy(p) for p in res]
    want = _jax_scan(tr if chroma else [tr[0], None, None], rs, groups, bd,
                     chroma)
    got = TIM.intra_scan_wave(tr, rs, torch.from_numpy(icu), level_off, bd,
                              chroma, None)
    _assert_scan_equal(got, want, chroma)


def _one_cu_frame(x, y, lw, lh):
    """A one-CU intra Main frame (64x64 picture)."""
    from types import SimpleNamespace
    a = np.array
    fs = SimpleNamespace(
        cu_x=a([x]), cu_y=a([y]), cu_log2w=a([lw]), cu_log2h=a([lh]),
        cu_pred_mode=a([0]), cu_ipm=a([5]), cu_ipm_c=a([0]), cu_tree=a([0]),
        w_pad=64, h_pad=64, h_scu=16, w_scu=16)
    job = SimpleNamespace(
        cu_nbr_up=a([0]), cu_nbr_left=a([0]), cu_nbr_right=a([0]),
        cu_nbr_upext=a([0]), cu_nbr_corner=a([0], np.uint8),
        cu_avail_lr=a([1]), cu_htdf_idx=None, cu_htdf_avail=None)
    return fs, job


@pytest.mark.parametrize("x,y,lw,lh", [(32, 0, 6, 5), (0, 48, 4, 5),
                                       (-4, 0, 2, 2)])
def test_pack_intra_main_refuses_cus_outside_their_plane(x, y, lw, lh):
    """The kernel reads without clamping: a CU that would leave the
    CTU-padded picture raises; the same frame in bounds packs."""
    fs, job = _one_cu_frame(x, y, lw, lh)
    with pytest.raises(ValueError, match="outside"):
        PK.pack_intra_main(fs, job, True)
    fs, job = _one_cu_frame(0, 0, lw, lh)
    table, level_off = PK.pack_intra_main(fs, job, True)
    assert table.shape == (1, 13) and list(level_off) == [0, 1]


def test_intra_scan_wave_plain_path_launches_nothing():
    recs, res, icu, level_off, _, _ = eipd_scene(64, 64, 8, 3)
    before = dict(K.launch_counts)
    TIM.intra_scan_wave([torch.from_numpy(p) for p in recs],
                        [torch.from_numpy(p) for p in res],
                        torch.from_numpy(icu), level_off, 8, True, None)
    assert K.launch_counts == before
    with pytest.raises(ValueError, match="1-D"):
        TIM.intra_scan_wave([torch.from_numpy(p) for p in recs],
                            [torch.from_numpy(p) for p in res],
                            torch.from_numpy(icu),
                            torch.from_numpy(level_off)[None], 8, True, None)


def _fused_order(icu, level_off, seed):
    """The rows level by level, each level's rows in a seeded random
    order: an order the CTAs of the CUDA scan may take them in."""
    rng = np.random.default_rng(seed)
    offs = [int(v) for v in level_off]
    return [r for lo, hi in zip(offs[:-1], offs[1:])
            for r in lo + rng.permutation(hi - lo)]


def _assert_fused_orders_match(recs, resids, icu, level_off, bd, chroma,
                               want, orders=2):
    """The level rule holds (`wave_level_check_ref`), and the plain
    level-by-level scan and each CU's prediction followed at once by its
    own HTDF, in `orders` random orders within the levels, all give `want`
    (JAX's scan)."""
    TIM.wave_level_check_ref(icu, level_off, chroma)
    rows = torch.as_tensor(icu)
    ref = [None if r is None else torch.as_tensor(r).clone() for r in recs]
    TIM.intra_scan_wave_ref(ref, resids, rows, level_off, bd, chroma)
    _assert_scan_equal(ref, want, chroma)
    for seed in range(orders):
        got = [None if r is None else torch.as_tensor(r).clone()
               for r in recs]
        order = _fused_order(icu, level_off, seed)
        assert order != list(range(len(order)))
        for r in order:
            TIM.eipd_cu_fused_ref(got, resids, rows[r], bd, chroma,
                                  rows.shape[1] > 13)
        _assert_scan_equal(got, want, chroma)


@pytest.mark.parametrize("chroma", [True, False])
def test_fused_htdf_order_matches_jax_on_synthetic_frame(chroma):
    """The CUDA scan's order on `eipd_scene` with HTDF (HTDF-only inter
    CUs, rectangles, trees): each CU's HTDF right after its prediction,
    the CUs of a level in random order, equals JAX's level scan."""
    bd = 10 if chroma else 8
    recs, res, icu, level_off, rows, levels = eipd_scene(128, 128, bd, 11,
                                                         chroma, True)
    groups = {S: jnp.asarray(a) for S, a in group_wavefront(
        rows, levels, rows[:, 2], rows[:, 3],
        lambda name, v: 1 << (v - 1).bit_length()).items()}
    tr = [torch.from_numpy(p) for p in recs]
    rs = [torch.from_numpy(p) for p in res]
    want = _jax_scan(tr if chroma else [tr[0], None, None], rs, groups, bd,
                     chroma)
    _assert_fused_orders_match(tr if chroma else [tr[0], None, None], rs, icu,
                               level_off, bd, chroma, want)


def test_fused_htdf_order_matches_jax_on_stream_frame(fixtures_dir):
    """The same on the HTDF P picture of a Main gate stream (the m_htdf_p
    case above), from the planes after ITDQ, MC and recon, with the level
    offsets from its device payload."""
    stream = make_stream(fixtures_dir / "torch_wave_m_htdf_p.evc", 176, 144,
                         4, 27, 602, "IPPP", profile=1,
                         tools=("htdf", "eipd", "cm_init", "admvp", "hmvp"))
    job, sps, refp, pf = max(
        captured_frames(stream),
        key=lambda f: (int(((f[0].fs.cu_pred_mode != 0)
                            & (f[0].cu_htdf_idx >= 0)).sum())
                       if f[3].refs else -1))
    recs, resids, df = planes_before_intra(pf, CPU)
    assert df.icu.shape[1] == 16 and df.level_off is not None
    groups = PL.JaxPixelBackend().pack_frame(job, sps, refp)["icu"]
    want = _jax_scan(recs, resids, groups, pf.bd, pf.chroma)
    _assert_fused_orders_match(recs, resids, df.icu, df.level_off, pf.bd,
                               pf.chroma, want)



@pytest.mark.parametrize("fault", ["one level", "HTDF on TREE_C"])
def test_level_rule_refuses_shared_cells(fault):
    """`wave_level_check_ref` refuses a schedule under which the fused
    order is not exact: every CU in one level, or HTDF on TREE_C CUs (a
    luma write the level rule does not order; the decoder never sets it).
    With the HTDF on TREE_C, the fused order indeed differs from the level
    scan."""
    bd = 8
    recs, res, icu, level_off, _, _ = eipd_scene(128, 128, bd, 15, False,
                                                 True)
    TIM.wave_level_check_ref(icu, level_off, False)
    if fault == "one level":
        level_off = np.array([0, len(icu)], np.int32)
    else:
        icu = icu.copy()
        icu[(icu[:, PK.ICM_TREE] == 2) & (icu[:, PK.ICM_VALID] == 1),
            PK.ICM_HTDF_IDX] = 0
    with pytest.raises(ValueError, match="level"):
        TIM.wave_level_check_ref(icu, level_off, False)
    if fault == "HTDF on TREE_C":
        rows = torch.from_numpy(icu)
        rs = [torch.from_numpy(p) for p in res]
        ref = [torch.from_numpy(recs[0]).clone(), None, None]
        TIM.intra_scan_wave_ref(ref, rs, rows, level_off, bd, False)
        got = [torch.from_numpy(recs[0]).clone(), None, None]
        for r in _fused_order(icu, level_off, 0):
            TIM.eipd_cu_fused_ref(got, rs, rows[r], bd, False, True)
        assert (got[0] != ref[0]).any()
