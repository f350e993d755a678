"""ITDQ of the PyTorch port against the JAX package (exact: integer).
The CUDA kernel is held to the plain version in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xevd_tpu.ops import jax_itdq as JQ
from xevd_tpu.ops import pipeline as PL
from xevd_tpu.ops import ref_numpy as RN
from xevd_tpu_torch.kernels import build as K
from xevd_tpu_torch.ops import itdq as TQ
from xevd_tpu_torch.ops import pack as PK
from xevd_tpu_torch.ops.tables import device_tables

from .test_torch_itdq_main import _jax_itdq_all as _jax_itdq_all_main
from .torch_helpers import itdq_class_frame, itdq_frame

CPU = torch.device("cpu")


def _blocks(log2, bd, n=9):
    rng = np.random.default_rng(log2 * 100 + bd)
    size = 1 << log2
    coef = rng.integers(-2000, 2000, size=(n, size, size)).astype(np.int32)
    coef[0, 0, 0] = 32767
    coef[1, 0, 0] = -32768
    coef[2] = rng.integers(-32768, 32768, size=(size, size))
    qps = rng.integers(0, 52 + 6 * (bd - 8), size=n)
    scales = np.array([RN.qp_scale(int(q)) for q in qps], np.int32)
    return coef, scales


@pytest.mark.parametrize("log2", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("bd", [8, 10])
def test_itdq_blocks_match_jax(log2, bd):
    coef, scales = _blocks(log2, bd)
    want = np.asarray(JQ.itdq_bucket(jnp.asarray(coef), jnp.asarray(scales),
                                     log2, log2, bd))
    got = TQ.itdq_blocks_ref(torch.from_numpy(coef), torch.from_numpy(scales),
                             log2, log2, bd, device_tables(CPU))
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_itdq_all(coefs, tus, shp_y, shp_c, bd):
    pk = PL._Packer()
    keys = sorted({(int(r[1]), int(r[2]), int(r[0])) for r in tus})
    for lw, lh, comp in keys:
        sel = tus[(tus[:, 1] == lw) & (tus[:, 2] == lh) & (tus[:, 0] == comp)]
        pk.add(f"q_{lw}_{lh}_{comp}_0", sel[:, 3:6])
    payload, sig = pk.finish()
    jc = tuple(jnp.asarray(c) for c in coefs) if shp_c else \
        (jnp.asarray(coefs[0]), jnp.zeros((8, 8), jnp.int16),
         jnp.zeros((8, 8), jnp.int16))
    out = PL._itdq_all(jnp.asarray(payload), jc, sig, shp_y, shp_c, bd)
    return [None if o is None else np.asarray(o) for o in out]


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("chroma", [True, False])
def test_itdq_frame_matches_jax_itdq_all(bd, chroma):
    coefs, tus, shp_y, shp_c = itdq_frame(bd, chroma=chroma)
    want = _jax_itdq_all(coefs, tus, shp_y, shp_c, bd)
    tc = [torch.from_numpy(c) for c in coefs] + [None] * (3 - len(coefs))
    got = TQ.itdq(tc, torch.from_numpy(tus), shp_y, shp_c, bd,
                  device_tables(CPU))
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), w)


def test_itdq_plain_path_launches_nothing():
    coefs, tus, shp_y, shp_c = itdq_frame(8, h=64, w=64)
    before = dict(K.launch_counts)
    TQ.itdq([torch.from_numpy(c) for c in coefs], torch.from_numpy(tus),
            shp_y, shp_c, 8, device_tables(CPU))
    assert K.launch_counts == before


def test_basis_sums_keep_the_kernel_in_int32():
    """The widths csrc/itdq.cu rests on, from the port's own tables: no
    column of a DCT-2 (2..64 points) or ATS basis (2..32) sums to more than
    3,707 in absolute value, so stage 0 on int16 input, and Main stage 1
    on its int16-clipped input, stay inside int32 -- and the Baseline
    stage-0 clip to +-(2^31 - 1) never acts.  Baseline stage 1 splits its
    input s into hi * 2^16 + lo; both half sums stay inside int32."""
    tab = device_tables(CPU)
    bases = [TQ.basis(tab, lg) for lg in range(1, 7)] + [
        TQ.basis(tab, lg, kind) for kind in (0, 1) for lg in range(1, 6)]
    m = max(int(b.abs().sum(0).max()) for b in bases)
    assert m == 3707
    s0 = 32768 * m                        # |dq| <= 32768
    assert s0 <= 2 ** 31 - 1
    assert 65535 * m < 2 ** 31            # the low halves, 0 <= lo < 2^16
    assert ((s0 >> 16) + 1) * m < 2 ** 31  # the high halves, |hi| <= ...


def _cta_slots(o):
    """The (order entry, row part) pairs the kernel's CTAs take, as
    csrc/itdq.cu maps them: CTA b's class is the last whose first CTA is
    <= b; with R CTAs a TU, its slot k takes entry first + ((b - first
    CTA) / R) * (256 / T) + k while below the count, and part (b - first
    CTA) mod R of its rows."""
    out = []
    for b in range(o.n_cta):
        k = np.searchsorted(o.classes[:, 0], b, side="right") - 1
        cta0, ord0, count, shape = (int(v) for v in o.classes[k])
        per_cta = PK.ITDQ_THREADS >> ((shape >> 8) & 15)
        lr = (shape >> 12) & 15
        for slot in range(per_cta):
            j = ((b - cta0) >> lr) * per_cta + slot
            if j < count:
                out.append((ord0 + j, (b - cta0) & ((1 << lr) - 1)))
    return out


def _jax_itdq_all_trs(coefs, tus, shp_y, shp_c, bd, iqt):
    """JAX's `_itdq_all` on a luma TU table bucketed by (size, trs), as
    its packer does (xevd_tpu/ops/pipeline.py `_pack_itdq`)."""
    pk = PL._Packer()
    keys = sorted({tuple(int(v) for v in r[[1, 2, 0, 6]]) for r in tus})
    for lw, lh, comp, trs in keys:
        sel = tus[(tus[:, 1] == lw) & (tus[:, 2] == lh) & (tus[:, 0] == comp)
                  & (tus[:, 6] == trs)]
        pk.add(f"q_{lw}_{lh}_{comp}_{trs}", sel[:, 3:6])
    payload, sig = pk.finish()
    z = jnp.zeros((8, 8), jnp.int16)
    out = PL._itdq_all(jnp.asarray(payload), (jnp.asarray(coefs[0]), z, z),
                       sig, shp_y, shp_c, bd, iqt)
    return [None if o is None else np.asarray(o) for o in out]


@pytest.mark.parametrize("frame_kind", ["quadtree", "classes"])
@pytest.mark.parametrize("main", [False, True])
@pytest.mark.parametrize("bd", [8, 10])
def test_class_order_fed_to_plain_itdq_matches_jax(main, bd, frame_kind):
    """The kernel's grouping of a frame's TUs by size class (ops/pack.py
    `itdq_order`): a permutation of the rows, each class's rows of its
    size and transform kind, every TU taken by exactly one CTA slot, the
    frame of each row carried beside it; and the plain ITDQ fed the TUs in
    that order equals JAX's `_itdq_all`.  On a quadtree frame of square
    TUs in three planes, and on a frame of every class (square and
    rectangular; Baseline beside ATS, or all Main; the trs codes a stream
    carries, which JAX decodes)."""
    if frame_kind == "quadtree":
        coefs, tus, shp_y, shp_c = itdq_frame(bd, main=main, seed=5)
    else:
        coef, tus, shp_y = itdq_class_frame(bd, main, seed=5, n=2,
                                            trs_codes=(5, 6, 9, 10))
        coefs, shp_c = [coef], None
    frame = np.random.default_rng(bd).integers(0, 4, len(tus))
    o = PK.itdq_order(tus, main, frame)
    perm = o.order[:, 0]
    assert sorted(perm.tolist()) == list(range(len(tus)))
    np.testing.assert_array_equal(o.order[:, 1], frame[perm])
    parts = np.ones(len(tus), np.int64)
    smem = 0
    for cta0, ord0, count, shape in o.classes:
        rows = tus[perm[ord0:ord0 + count]]
        lw, lh = (shape >> 4) & 15, shape & 15
        assert (rows[:, PK.TU_LOG2W] == lw).all()
        assert (rows[:, PK.TU_LOG2H] == lh).all()
        assert ((rows[:, PK.TU_TRS] != 0) | main == (shape >> 16) & 1).all()
        n, t = 1 << (lw + lh), 1 << ((shape >> 8) & 15)
        r = 1 << ((shape >> 12) & 15)
        assert r == max(1, n // 1024) and t == min(256, max(16, n // 4 // r))
        parts[ord0:ord0 + count] = r
        smem = max(smem, (256 // t) * (2 * n + 4 * n // r))
    assert o.smem == smem
    # every TU taken once, in each of its R row parts
    assert sorted(_cta_slots(o)) == [(e, p) for e in range(len(tus))
                                     for p in range(parts[e])]
    assert len(o.classes) == (5 if frame_kind == "quadtree" else
                              36 if main else 36 + 25)
    tc = [torch.from_numpy(c) for c in coefs] + [None] * (3 - len(coefs))
    got = TQ.itdq_ref(tc, torch.from_numpy(tus[perm]), shp_y, shp_c, bd,
                      device_tables(CPU), main)
    if frame_kind == "classes":
        want = _jax_itdq_all_trs(coefs, tus, shp_y, shp_c, bd, main)
    else:
        want = (_jax_itdq_all_main if main else _jax_itdq_all)(
            coefs, tus, shp_y, shp_c, bd)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), w)
