"""The Main variants of the port's ITDQ against the JAX package (exact:
integer): the per-stage-clipped DCT-2 (`iqt`) and the ATS DST-7/DCT-8
bases (`trs`) of `itdq_bucket`, and a real frame with intra and inter ATS
against `_itdq_all`.  The CUDA kernel is held to the plain version in
test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xevd_tpu.ops import jax_itdq as JQ
from xevd_tpu.ops import pipeline as PL
from xevd_tpu.ops import ref_numpy as RN
from xevd_tpu_torch.ops import itdq as TQ
from xevd_tpu_torch.ops import pack as PK
from xevd_tpu_torch.ops.tables import device_tables

from .conftest import make_stream
from .torch_helpers import captured_frames, itdq_frame

CPU = torch.device("cpu")
TAB = device_tables(CPU)


def _blocks(lw, lh, bd, n=8, seed=0):
    """n blocks with coefficients over the whole int16 range (both ends
    included), Main scales of random QPs."""
    rng = np.random.default_rng(seed + 97 * lw + 13 * lh + bd)
    coef = rng.integers(-32768, 32768, size=(n, 1 << lh, 1 << lw))
    coef[0, 0, 0], coef[1, 0, 0] = 32767, -32768
    coef[2:4] = rng.integers(-400, 400, size=(2, 1 << lh, 1 << lw))
    qps = rng.integers(0, 52 + 6 * (bd - 8), size=n)
    scales = np.array([RN.qp_scale(int(q), True) for q in qps], np.int32)
    return coef.astype(np.int32), scales


def _check(lw, lh, bd, iqt, trs):
    coef, scales = _blocks(lw, lh, bd, seed=trs)
    want = np.asarray(JQ.itdq_bucket(jnp.asarray(coef), jnp.asarray(scales),
                                     lw, lh, bd, iqt, trs))
    got = TQ.itdq_blocks_ref(torch.from_numpy(coef), torch.from_numpy(scales),
                             lw, lh, bd, TAB, iqt, trs)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want,
                                  err_msg=f"{1 << lw}x{1 << lh} trs {trs}")


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("lw,lh", [(1, 1), (2, 2), (3, 3), (4, 4), (5, 5),
                                   (6, 6), (1, 3), (3, 1), (2, 5), (5, 2),
                                   (3, 6), (6, 4)])
def test_iqt_blocks_match_jax(lw, lh, bd):
    _check(lw, lh, bd, True, 0)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("trs", [5, 6, 9, 10])
def test_ats_blocks_match_jax(trs, bd):
    """Every DST-7/DCT-8 pair at every ATS size, square and not."""
    for lw in range(2, 6):
        for lh in range(2, 6):
            _check(lw, lh, bd, True, trs)


def test_pack_refuses_ats_on_a_side_of_64():
    """The ATS bases stop at 32: a TU with trs and a side of 64 raises."""
    from types import SimpleNamespace
    a = np.array
    fs = SimpleNamespace(
        cu_x=a([0]), cu_y=a([0]), cu_log2w=a([6]), cu_log2h=a([5]),
        cu_pred_mode=a([0]), cu_qp=a([30]), cu_qp_u=a([30]), cu_qp_v=a([30]),
        cu_cbf=a([[1, 0, 0]]), cu_ats=a([[1, 2, 0]]),
        coef_y=np.zeros((64, 64), np.int16),
        coef_u=np.zeros((32, 32), np.int16),
        coef_v=np.zeros((32, 32), np.int16))
    with pytest.raises(ValueError, match="64"):
        PK.pack_itdq(fs, 8, True, iqt=True, main=True)
    with pytest.raises(Exception, match="Main only"):
        PK.pack_itdq(fs, 8, True)            # a Baseline frame with ATS
    fs.cu_log2w = a([5])
    assert PK.pack_itdq(fs, 8, True, iqt=True, main=True)[0, PK.TU_TRS] == 9


@pytest.mark.parametrize("bd", [8, 10])
def test_itdq_ref_main_frame_matches_jax_itdq_all(bd):
    """The frame path groups TUs by trs: a synthetic Main TU table with
    DCT-2 and ATS TUs through `itdq_ref` equals `_itdq_all(iqt=True)` on
    the same TUs bucketed as the JAX packer does."""
    coefs, tus, shp_y, shp_c = itdq_frame(bd, main=True, seed=3)
    assert 0 in tus[:, PK.TU_TRS] and len(set(tus[:, PK.TU_TRS])) >= 4
    got = TQ.itdq_ref([torch.from_numpy(c) for c in coefs],
                      torch.from_numpy(tus), shp_y, shp_c, bd, TAB, True)
    want = _jax_itdq_all(coefs, tus, shp_y, shp_c, bd)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def _jax_itdq_all(coefs, tus, shp_y, shp_c, bd):
    pk = PL._Packer()
    keys = sorted({tuple(int(v) for v in r[[1, 2, 0, 6]]) for r in tus})
    for lw, lh, comp, trs in keys:
        sel = tus[(tus[:, 1] == lw) & (tus[:, 2] == lh) & (tus[:, 0] == comp)
                  & (tus[:, 6] == trs)]
        pk.add(f"q_{lw}_{lh}_{comp}_{trs}", sel[:, 3:6])
    payload, sig = pk.finish()
    out = PL._itdq_all(jnp.asarray(payload),
                       tuple(jnp.asarray(c) for c in coefs), sig, shp_y,
                       shp_c, bd, True)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("name,w,h,n,qp,seed,gop,tools,inter", [
    ("m_ats_i", 176, 144, 2, 30, 117, "I",
     ("iqt", "ats", "eipd", "cm_init"), False),
    # m_ats_p of tests/test_main_profile.py without SUCO (not ported)
    ("ats_p_nosuco", 176, 144, 3, 32, 118, "IPPP",
     ("iqt", "ats", "admvp", "hmvp", "btt", "cm_init", "eipd"), True),
])
def test_itdq_ref_matches_jax_on_ats_frame(fixtures_dir, name, w, h, n, qp,
                                          seed, gop, tools, inter):
    """A real frame with intra ATS (and, in the P stream, ATS-inter
    sub-TUs): the frame with the most ATS TUs, its TU table packed by
    `pack_itdq`, against `_itdq_all(iqt=True)` on JaxPixelBackend's
    payload."""
    stream = make_stream(fixtures_dir / f"torch_itdqm_{name}.evc", w, h, n, qp,
                         seed, gop, profile=1, tools=tools)
    frames = captured_frames(stream)

    def n_ats(f):
        return int((f[0].fs.cu_ats[:, 2 if inter else 0] != 0).sum())
    job, sps, refp, pf = max(frames, key=n_ats)
    assert n_ats((job, sps, refp, pf)) > 0
    assert pf.iqt and (PK.upload(pf, CPU).tus[:, PK.TU_TRS] != 0).any()
    pack = PL.JaxPixelBackend().pack_frame(job, sps, refp)
    st = pack["static"]
    want = PL._itdq_all(jnp.asarray(pack["payload"]),
                        tuple(jnp.asarray(c) for c in pack["coefs"]),
                        st["sig_q"], st["shp_y"], st["shp_c"], st["bd"], True)
    df = PK.upload(pf, CPU)
    got = TQ.itdq_ref((df.coef_y, df.coef_u, df.coef_v), df.tus, pf.shp_y,
                      pf.shp_c, pf.bd, TAB, pf.iqt)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
