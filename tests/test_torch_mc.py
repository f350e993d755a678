"""Motion compensation and recon with prediction of the PyTorch port
against the JAX package (`mc_bucket`, `_mc_all`, `_recon_plane`; exact:
integer), with the Baseline and the Main (ADMVP) taps.  The CUDA and
Triton kernels are held to the plain versions in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xevd_tpu.ops import jax_mc as JM
from xevd_tpu.ops import pipeline as PL
from xevd_tpu_torch.kernels import build as K
from xevd_tpu_torch.ops import mc as TM
from xevd_tpu_torch.ops import pack as PK
from xevd_tpu_torch.ops import recon as TR
from xevd_tpu_torch.ops.tables import device_tables

from .conftest import make_stream
from .torch_helpers import (captured_frames, mc_blocks, mc_frame, mc_shapes,
                            recon_pred_planes)

CPU = torch.device("cpu")
TAB = device_tables(CPU)


def _mc_blocks_vs_jax(case, is_luma, bd, main_taps):
    rng = np.random.default_rng(10 * case + bd + is_luma + 50 * main_taps)
    smax = 64 if is_luma else 32
    hw = (2 * smax + 16, 2 * smax + 24)
    refs = np.stack([rng.integers(0, 1 << bd, size=hw),
                     rng.integers(-32768, 32768, size=hw)]).astype(np.int16)
    sizes = [(s, s) for s in (smax >> 4, smax >> 3, smax >> 2, smax >> 1,
                              smax)] + [(smax >> 1, smax >> 3)]
    for w, h in sizes:
        slot, gx, gy = (a.astype(np.int32) for a in mc_blocks(
            rng, 8, is_luma, case, (w, h), hw))
        want = np.asarray(JM.mc_bucket(
            (jnp.asarray(refs), jnp.asarray(slot), jnp.asarray(gx),
             jnp.asarray(gy)), case, w, h, bd, is_luma, main_taps))
        got = TM.mc_blocks_ref(torch.from_numpy(refs), torch.from_numpy(slot),
                               torch.from_numpy(gx), torch.from_numpy(gy),
                               case, w, h, bd, is_luma, TAB, main_taps)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{w}x{h}")


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("is_luma", [True, False])
@pytest.mark.parametrize("case", [0, 1, 2, 3])
def test_mc_blocks_match_jax_mc_bucket(case, is_luma, bd):
    """Every size, two reference slots (the second over the whole int16
    range, so NN's int16 intermediate wraps), and a quarter of the
    filtering blocks at phase 0 (a clipped MV under a filtering case)."""
    _mc_blocks_vs_jax(case, is_luma, bd, False)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("is_luma", [True, False])
@pytest.mark.parametrize("case", [0, 1, 2, 3])
def test_mc_blocks_main_taps_match_jax_mc_bucket(case, is_luma, bd):
    """The same blocks with the Main (ADMVP) tap tables."""
    _mc_blocks_vs_jax(case, is_luma, bd, True)


def _jax_mc_all(pack):
    """JAX `_mc_all` on a JaxPixelBackend payload; the reference planes
    (the port's DevicePlanes) carried across as numpy arrays."""
    st = pack["static"]
    refs = tuple(jnp.stack([jnp.asarray(np.asarray(p)) for p in planes])
                 if planes else None for planes in pack["refs"])
    out = PL._mc_all(jnp.asarray(pack["payload"]), refs, st["sig_m"],
                     st["shp_y"], st["shp_c"], st["bd"],
                     st.get("main_taps", False))
    return [None if o is None else np.asarray(o) for o in out]


def _assert_planes_equal(got, want):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert (g is None) == (w is None), i
        if g is not None:
            assert g.dtype == (torch.int32 if i in (0, 2, 3) else torch.int8)
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"plane {i}")


@pytest.mark.parametrize("chroma", [True, False])
def test_mc_all_matches_jax_on_synthetic_frame(chroma):
    """Every case, both lists, the MV clip and the identical-motion skip,
    packed by both packers from one frame; 4:0:0 included."""
    fs, job, refp = mc_frame(96, 160, 10, chroma, seed=5)
    table, lists, refs = PK.pack_mc(fs, job, refp, chroma)
    assert lists == tuple(int((table[:, PK.MC_LIST] == i).sum())
                          for i in (0, 1))
    assert (table[:lists[0], PK.MC_LIST] == 0).all()
    assert set(table[:, PK.MC_CASE]) == {0, 1, 2, 3}
    assert set(table[:, PK.MC_LIST]) == {0, 1}
    jb = PL.JaxPixelBackend()
    pk = PL._Packer()
    jrefs, has_inter = jb._pack_mc(pk, fs, job, refp, chroma)
    assert has_inter
    payload, sig = pk.finish()
    shp_y, shp_c = mc_shapes(fs, chroma)
    want = _jax_mc_all({"payload": payload, "refs": jrefs, "static": dict(
        sig_m=sig, shp_y=shp_y, shp_c=shp_c, bd=10)})
    got = TM.mc_all_ref(torch.from_numpy(table), refs, shp_y, shp_c, 10, TAB)
    _assert_planes_equal(got, want)
    assert (got[1] == 2).any()             # bi-predicted samples


@pytest.mark.parametrize("name,w,h,n,qp,seed,gop,profile,tools", [
    ("p176x144", 176, 144, 4, 35, 7, "IPPP", 0, ()),
    ("ra176x144", 176, 144, 9, 32, 10, "RA", 0, ()),
    # tests/test_main_profile.py m_admvp_ra: Main taps, both lists
    ("main_m_admvp_ra", 176, 144, 5, 30, 113, "RA", 1,
     ("admvp", "hmvp", "cm_init", "eipd")),
])
def test_mc_all_matches_jax_on_stream_frame(fixtures_dir, name, w, h, n, qp,
                                            seed, gop, profile, tools):
    """A real P frame and real B frames (Baseline, and Main with the ADMVP
    taps): the frame with the most list-1 rows (else the most rows), its
    payload packed by JaxPixelBackend."""
    stream = make_stream(fixtures_dir / f"torch_mc_{name}.evc", w, h, n, qp,
                         seed, gop, profile=profile, tools=tools)
    frames = [f for f in captured_frames(stream) if f[3].refs]
    assert frames
    job, sps, refp, pf = max(frames, key=lambda f: (f[3].mc_lists[1],
                                                    sum(f[3].mc_lists)))
    if gop == "RA":
        assert pf.mc_lists[1] > 0
    assert pf.main_taps == bool(profile)
    want = _jax_mc_all(PL.JaxPixelBackend().pack_frame(job, sps, refp))
    df = PK.upload(pf, CPU)
    got = TM.mc_all_ref(df.mc, pf.refs, pf.shp_y, pf.shp_c, pf.bd, TAB,
                        pf.main_taps)
    _assert_planes_equal(got, want)


@pytest.mark.parametrize("bd", [8, 10])
def test_recon_with_prediction_matches_jax_recon_plane(bd):
    """cnt in {0, 1, 2}; pred + resid beyond the int16 range (wraps)."""
    resid, pred, cnt = recon_pred_planes(bd)
    want = np.asarray(PL._recon_plane(jnp.asarray(pred), jnp.asarray(cnt),
                                      jnp.asarray(resid), bd))
    got = TR.recon(torch.from_numpy(resid), bd, torch.from_numpy(pred),
                   torch.from_numpy(cnt))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        TR.recon(torch.from_numpy(resid), bd, torch.from_numpy(pred))


def test_pack_mc_refuses_windows_outside_their_planes():
    """The kernel reads without clamping: a reference plane too small for
    a window, or a CU outside the padded picture, raises."""
    fs, job, refp = mc_frame(64, 64, 8, True, seed=1)
    table, _, _ = PK.pack_mc(fs, job, refp, True)
    assert len(table)
    for lists in refp:
        for r in lists:
            r.pic.y = r.pic.y[:100, :]       # far too few rows
    with pytest.raises(ValueError, match="window"):
        PK.pack_mc(fs, job, refp, True)
    fs, job, refp = mc_frame(64, 64, 8, True, seed=1)
    fs.cu_pred_mode[:] = 1
    fs.cu_x = fs.cu_x + 8
    with pytest.raises(ValueError, match="outside"):
        PK.pack_mc(fs, job, refp, True)


def test_mc_plain_path_launches_nothing():
    fs, job, refp = mc_frame(64, 64, 8, True, seed=2)
    table, lists, refs = PK.pack_mc(fs, job, refp, True)
    shp_y, shp_c = mc_shapes(fs, True)
    before = dict(K.launch_counts)
    TM.mc_all(torch.from_numpy(table), lists, refs, shp_y, shp_c, 8, TAB)
    assert K.launch_counts == before
