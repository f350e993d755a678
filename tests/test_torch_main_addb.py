"""The PyTorch port's ADDB deblocking (K11, driven by K12
`_deblock_finish_addb`) on the CPU.

- each plain pass (`ops/addb.py` `*_ref`, the host copy of addb_common's
  line filters through a torch shim) equals its JAX function
  (`addb_luma_ver`, `addb_luma_hor`, `addb_chroma_ver`,
  `addb_chroma_hor`) on seeded planes and parameter maps at 8 and 10 bit,
  the chroma passes with the U and the V channels of the 7-channel map;
- `addb_frame` on the H8 x W8 crop of bordered planes equals the JAX
  `_deblock_finish_addb` (pass order, crop, U/V channel selection);
- `addb_blocks_ref`, the fused kernel's order (each shifted block ver then
  hor, the blocks of Y, U and V in three random orders), equals
  `_deblock_finish_addb` on dense maps, maps with bs 4 everywhere and
  maps with no edge, 8 and 10 bit, 4:2:0 and 4:0:0, areas one SCU past
  the SCU grid;
- the M7 gate cases, tuples of tests/test_main_profile.py CASES, decode
  byte-equal with the torch backend (plain PyTorch versions), the JAX
  backend and the numpy oracle backend.  The cases marked `slow` take
  minutes of JAX compiles (left out of tier-1); their tools are all in
  `m10_all` (test_torch_main_full.py), which runs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xevd_tpu.ops import jax_deblock as JD
from xevd_tpu.ops import pipeline as PL
from xevd_tpu_torch.ops import addb as TA
from xevd_tpu_torch.ops.tables import BORDER

from .test_torch_slice import assert_backends_agree
from .torch_helpers import addb_pars, bordered, smooth_plane

CASES = [
    # name, w, h, frames, qp, seed, gop, tools
    ("m_addb_i", 176, 144, 2, 30, 501, "I", ("addb", "eipd", "cm_init")),
    ("m_addb_p", 176, 144, 4, 31, 502, "IPPP",
     ("addb", "eipd", "cm_init", "admvp", "hmvp")),
    pytest.param("m_addb_ra", 176, 144, 5, 30, 503, "RA",
                 ("addb", "eipd", "cm_init", "admvp", "hmvp", "mmvd", "amvr",
                  "btt", "suco", "adcc"), marks=pytest.mark.slow),
    pytest.param("m_addb_ats", 176, 144, 3, 32, 504, "IPPP",
                 ("addb", "eipd", "cm_init", "iqt", "ats", "btt", "suco",
                  "admvp", "hmvp"), marks=pytest.mark.slow),
    pytest.param("m_htdf_all", 176, 144, 5, 29, 603, "RA",
                 ("htdf", "addb", "eipd", "cm_init", "iqt", "ats", "btt",
                  "suco", "admvp", "hmvp", "mmvd", "amvr", "adcc"),
                 marks=pytest.mark.slow),
]

_JAX = {"luma_ver": JD.addb_luma_ver, "luma_hor": JD.addb_luma_hor,
        "chroma_ver": JD.addb_chroma_ver, "chroma_hor": JD.addb_chroma_hor}


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("kind,cb", [("luma_ver", 1), ("luma_hor", 1),
                                     ("chroma_ver", 1), ("chroma_ver", 4),
                                     ("chroma_hor", 1), ("chroma_hor", 4)])
def test_addb_pass_plain_equals_jax(kind, cb, bd):
    rng = np.random.default_rng(bd + 3 * cb + len(kind))
    luma = kind.startswith("luma")
    u = 4 if luma else 2
    H, W = (48, 96) if luma else (24, 48)
    area = smooth_plane(rng, H, W, bd)
    pars = addb_pars(rng, H // u, W // u, bd, 4 if luma else 7)[0]
    sel = pars[..., [0, cb, cb + 1, cb + 2]]
    want = np.asarray(_JAX[kind](jnp.asarray(area), jnp.asarray(sel), bd))
    got = torch.from_numpy(area.copy())
    TA.addb_pass(kind, got, torch.from_numpy(pars), bd, cb)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, area)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("h_scu,w_scu", [(16, 24), (15, 21)])
def test_addb_frame_equals_deblock_finish_addb(bd, h_scu, w_scu):
    """Odd SCU counts: the maps are padded to even ones and the crop
    reaches one SCU past the SCU area."""
    rng = np.random.default_rng(bd + h_scu)
    hs2, ws2 = (h_scu + 1) & ~1, (w_scu + 1) & ~1
    H8, W8 = 4 * hs2, 4 * ws2
    recs = [bordered(rng, H8, W8, 0, 1 << bd) for _ in range(3)]
    recs[0][BORDER:BORDER + H8, BORDER:BORDER + W8] = smooth_plane(
        rng, H8, W8, bd)
    for r in recs[1:]:
        r[BORDER:BORDER + H8 // 2, BORDER:BORDER + W8 // 2] = smooth_plane(
            rng, H8 // 2, W8 // 2, bd)
    luma = np.zeros((2, hs2, ws2, 4), np.int32)
    chroma = np.zeros((2, hs2, ws2, 7), np.int32)
    luma[:, :h_scu, :w_scu] = addb_pars(rng, h_scu, w_scu, bd, 4)
    chroma[:, :h_scu, :w_scu] = addb_pars(rng, h_scu, w_scu, bd, 7)
    geom = (4 * h_scu, 4 * w_scu, h_scu, w_scu)
    want = PL._deblock_finish_addb(tuple(recs), (luma, chroma), geom, bd,
                                   True, 144, False)
    planes = [torch.from_numpy(r.copy()) for r in recs]
    areas = [planes[0][BORDER:BORDER + H8, BORDER:BORDER + W8]] + [
        p[BORDER:BORDER + H8 // 2, BORDER:BORDER + W8 // 2]
        for p in planes[1:]]
    TA.addb_frame(*areas, torch.from_numpy(luma), torch.from_numpy(chroma),
                  bd)
    for a, w in zip(areas, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


def _addb_frame_inputs(rng, h_scu, w_scu, bd, maps="dense"):
    """Bordered planes (smooth areas) and maps padded to even SCU counts,
    the H8 x W8 crop one SCU past the SCU area where a count is odd:
    `maps` "dense" (random bs), "strong" (bs 4 everywhere) or "none"."""
    hs2, ws2 = (h_scu + 1) & ~1, (w_scu + 1) & ~1
    H8, W8 = 4 * hs2, 4 * ws2
    recs = [bordered(rng, H8, W8, 0, 1 << bd) for _ in range(3)]
    recs[0][BORDER:BORDER + H8, BORDER:BORDER + W8] = smooth_plane(
        rng, H8, W8, bd)
    for r in recs[1:]:
        r[BORDER:BORDER + H8 // 2, BORDER:BORDER + W8 // 2] = smooth_plane(
            rng, H8 // 2, W8 // 2, bd)
    luma = np.zeros((2, hs2, ws2, 4), np.int32)
    chroma = np.zeros((2, hs2, ws2, 7), np.int32)
    luma[:, :h_scu, :w_scu] = addb_pars(rng, h_scu, w_scu, bd, 4)
    chroma[:, :h_scu, :w_scu] = addb_pars(rng, h_scu, w_scu, bd, 7)
    for m in (luma, chroma):
        if maps != "dense":
            m[:, :h_scu, :w_scu, 0] = 4 if maps == "strong" else 0
    return recs, luma, chroma, (H8, W8)


def _areas(planes, H8, W8, chroma=True):
    return [planes[0][BORDER:BORDER + H8, BORDER:BORDER + W8]] + [
        p[BORDER:BORDER + H8 // 2, BORDER:BORDER + W8 // 2] if chroma
        else None for p in planes[1:]]


@pytest.mark.parametrize("chroma", [True, False])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("maps", ["dense", "strong", "none"])
def test_addb_blocks_ref_any_order_equals_jax(maps, bd, chroma):
    """The rule the fused kernel relies on: shifted blocks filtered ver
    then hor, in any order, give JAX's reference-order result."""
    rng = np.random.default_rng(40 + bd + 3 * len(maps) + chroma)
    h_scu, w_scu = 9, 13
    recs, luma, chroma_p, (H8, W8) = _addb_frame_inputs(rng, h_scu, w_scu,
                                                        bd, maps)
    want = PL._deblock_finish_addb(tuple(recs), (luma, chroma_p),
                                   (4 * h_scu, 4 * w_scu, h_scu, w_scu), bd,
                                   chroma, 144, False)
    for k in range(3):
        planes = [torch.from_numpy(r.copy()) for r in recs]
        areas = _areas(planes, H8, W8, chroma)
        TA.addb_blocks_ref(*areas, torch.from_numpy(luma),
                           torch.from_numpy(chroma_p), bd,
                           order=np.random.default_rng(k))
        for a, w in zip(areas, want):
            assert (a is None) == (w is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    before = recs[0][BORDER:BORDER + H8, BORDER:BORDER + W8]
    assert np.array_equal(np.asarray(want[0]), before) == (maps == "none")


@pytest.mark.parametrize("name,w,h,n,qp,seed,gop,tools", CASES)
def test_torch_main_addb_equals_jax_and_numpy(
        fixtures_dir, tmp_path, name, w, h, n, qp, seed, gop, tools):
    assert_backends_agree(fixtures_dir, tmp_path, f"main_{name}", w, h, n, qp,
                          seed, gop, 8, profile=1, tools=tools)
