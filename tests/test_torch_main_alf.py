"""The PyTorch port's ALF (K13 `alf_apply`) on the CPU.

- `ops/alf.py` `alf_frame` (plain versions) returns planes equal to the
  JAX `alf_apply`'s in-place result, and leaves its areas untouched, on
  seeded planes, coefficients and CTU flags: 8 and 10 bit (10-bit noise
  makes the classifier's 32-bit products wrap), CTU 64 and 128,
  `across_tiles` 0 and 1, partial CTUs at the right and bottom edges, an
  area larger than the picture (as after ADDB's crop), each plane enabled
  or not;
- the kernel's split, stated in plain PyTorch, equals JAX: the
  classification from Laplacians summed once into 4x4 groups
  (`_classify` over `_group_sums`) equals `_classify` on noisy and
  directional windows (CTU 64 and 128, 8 and 10 bit); `alf_runs_ref`
  (runs of 4 samples, one row of the transposed coefficient table each,
  unflagged luma CTUs copied) equals `alf_apply` on every plane, and
  `alf_frame`'s returned planes, pad-expanded by `pad_picture`, equal JAX's padded
  planes for each subset of `enables` -- CTU 64 and 128, across 0 and 1,
  mixed CTU flags, 8 and 10 bit, pictures that are not CTU multiples;
- the pack's ALF parameters equal the JAX pack's (`recon_coef_arrays`,
  CTU flags, configuration) on the frames of an ALF stream;
- the M8 gate cases, tuples of tests/test_main_profile.py CASES and
  CASES10, decode byte-equal with the torch backend (plain PyTorch
  versions), the JAX backend and the numpy oracle backend; `m_alf_all`
  and `m10_all` are in test_torch_main_full.py, so that the JAX compiles
  spread over the workers of a parallel run.  The cases marked `slow`
  take minutes of JAX compiles (left out of tier-1); `m10_all` runs with
  all of their tools, at 10 bit."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xevd_tpu.ops import jax_alf as JA
from xevd_tpu.ops import pipeline as PL
from xevd_tpu_torch.ops import alf as TL
from xevd_tpu_torch.ops import pack as PK
from xevd_tpu_torch.ops.recon import pad_picture
from xevd_tpu_torch.ops.tables import PAD_L

from .test_torch_slice import _stream, assert_backends_agree
from .torch_helpers import alf_coefs, captured_frames

CASES = [
    # name, w, h, frames, qp, seed, gop, tools, bit depth, frames decoded
    ("m_alf_i", 176, 144, 3, 30, 711, "I", ("alf", "eipd", "cm_init"), 8, 3),
    ("m_alf_p", 176, 144, 4, 30, 702, "IPPP",
     ("alf", "eipd", "cm_init", "admvp", "hmvp"), 8, 4),
    # six frames of RA decode to nine: the GOP is rounded up
    pytest.param("m_alf_ra", 176, 144, 6, 29, 712, "RA",
                 ("alf", "eipd", "cm_init", "admvp", "hmvp", "btt", "suco",
                  "adcc"), 8, 9, marks=pytest.mark.slow),
    pytest.param("m10_alf_p", 176, 144, 5, 31, 803, "RA",
                 ("alf", "eipd", "cm_init", "admvp", "hmvp"), 10, 5,
                 marks=pytest.mark.slow),
]
# alf_apply under jit, as the JAX pipeline runs it (one compile a
# configuration instead of one per eager op)
_ALF_APPLY = jax.jit(JA.alf_apply, static_argnums=tuple(range(6, 13)))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("log2_ctu,h,w,enables", [
    (6, 144, 176, (True, True, True)),
    (6, 96, 136, (True, False, True)),
    (7, 136, 200, (False, True, True)),
])
@pytest.mark.parametrize("across", [0, 1])
def test_alf_plain_equals_jax(bd, log2_ctu, h, w, enables, across):
    rng = np.random.default_rng(bd + 7 * log2_ctu + h + across)
    H, W = h + 8, w + 16        # the area reaches past the picture
    y, u, v = (rng.integers(0, 1 << bd, size=s).astype(np.int16)
               for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
    cl, cc = alf_coefs(rng)
    S = 1 << log2_ctu
    ctu_on = (rng.random(-(-h // S) * -(-w // S)) < 0.7).astype(np.int32)
    want = _ALF_APPLY(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
                      jnp.asarray(cl), jnp.asarray(cc), jnp.asarray(ctu_on),
                      h, w, log2_ctu, enables, bd, across, True)
    areas = [torch.from_numpy(p.copy()) for p in (y, u, v)]
    outs = TL.alf_frame(*areas, torch.from_numpy(cl), torch.from_numpy(cc),
                        torch.from_numpy(ctu_on), h, w,
                        (enables, log2_ctu, bool(across)), bd)
    sizes = [(h, w)] + [(h >> 1, w >> 1)] * 2
    for o, a, wnt, p, (ph, pw), en in zip(outs, areas, want, (y, u, v),
                                          sizes, enables):
        # the areas are left as they were; JAX's in-place result outside
        # the picture is the area's
        np.testing.assert_array_equal(a.numpy(), p)
        np.testing.assert_array_equal(o.numpy()[:ph, :pw],
                                      np.asarray(wnt)[:ph, :pw])
        np.testing.assert_array_equal(np.asarray(wnt)[ph:], p[ph:])
        np.testing.assert_array_equal(np.asarray(wnt)[:, pw:], p[:, pw:])
        assert np.array_equal(o.numpy()[:ph, :pw], p[:ph, :pw]) != en


def _windows_mix(rng, n, S, bd):
    """[2 n, S + 6, S + 6] int32 windows: noise over the whole range (the
    10-bit sums make the classifier's products wrap), and windows of 8 x 8
    tiles, each a mix of horizontal, vertical and two diagonal stripe
    patterns with amplitudes from 0 to a quarter of the range (every
    activity, direction and strength class)."""
    N = S + 6
    maxv = (1 << bd) - 1
    yy, xx = np.mgrid[0:8, 0:8]
    pats = np.stack([yy % 2, xx % 2, (yy + xx) % 2, (yy // 2 + xx) % 2])
    t = -(-N // 8)
    amp = (rng.integers(0, 4, size=(n, t, t, 4, 1, 1))
           << rng.integers(0, bd - 2, size=(n, t, t, 1, 1, 1))) * (
        rng.random((n, t, t, 4, 1, 1)) < 0.6)
    tiles = (pats * amp).sum(3).transpose(0, 1, 3, 2, 4).reshape(
        n, 8 * t, 8 * t)
    tiled = tiles[:, :N, :N] + maxv // 3
    noise = rng.integers(0, maxv + 1, size=(n, N, N))
    return np.concatenate([noise, np.clip(tiled, 0, maxv)]).astype(np.int32)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("log2_ctu", [6, 7])
def test_alf_group_sum_classify_equals_jax(bd, log2_ctu):
    S = 1 << log2_ctu
    bufs = _windows_mix(np.random.default_rng(bd + log2_ctu), 6, S, bd)
    want = jax.jit(jax.vmap(JA._classify, in_axes=(0, None, None)),
                   static_argnums=(1, 2))(jnp.asarray(bufs), bd, S)
    cls, trans = TL._classify(torch.from_numpy(bufs), bd, S)
    np.testing.assert_array_equal(((cls << 2) | trans).numpy(),
                                  np.asarray(want))
    assert len(np.unique(np.asarray(want) >> 2)) >= 12


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("log2_ctu,h,w", [(6, 104, 136), (7, 136, 200)])
@pytest.mark.parametrize("across", [0, 1])
def test_alf_runs_and_frame_pad_equal_jax(bd, log2_ctu, h, w, across):
    """Pictures that are not CTU multiples, in areas larger than the
    picture; CTU flags mixed."""
    rng = np.random.default_rng(60 + bd + log2_ctu + across)
    H, W = h + 8, w + 16
    yy, xx = np.mgrid[0:H, 0:W]
    y = np.clip((yy + 2 * xx) * ((1 << bd) - 1) // (H + 2 * W)
                + rng.integers(-6, 7, size=(H, W)) * (1 << (bd - 8)), 0,
                (1 << bd) - 1)
    planes = [y.astype(np.int16)] + [
        rng.integers(0, 1 << bd, size=(H // 2, W // 2)).astype(np.int16)
        for _ in range(2)]
    cl, cc = alf_coefs(rng)
    S = 1 << log2_ctu
    n_ctu = -(-h // S) * -(-w // S)
    ctu_on = (np.arange(n_ctu) % 3 != 1).astype(np.int32)
    coef = {True: torch.from_numpy(cl), False: torch.from_numpy(cc)}
    on = torch.from_numpy(ctu_on)
    want = _ALF_APPLY(*map(jnp.asarray, planes), jnp.asarray(cl),
                      jnp.asarray(cc), jnp.asarray(ctu_on), h, w, log2_ctu,
                      (True, True, True), bd, across, True)
    sizes = [(h, w, log2_ctu)] + [(h >> 1, w >> 1, log2_ctu - 1)] * 2
    for i, (p, wnt, (ph, pw, lg)) in enumerate(zip(planes, want, sizes)):
        got = TL.alf_runs_ref(torch.from_numpy(p), coef[i == 0], on, ph, pw,
                              lg, bd, bool(across), i == 0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(wnt)[:ph, :pw])
    for enables in itertools.product((False, True), repeat=3):
        areas = [torch.from_numpy(p.copy()) for p in planes]
        outs = TL.alf_frame(*areas, coef[True], coef[False], on, h, w,
                            (enables, log2_ctu, bool(across)), bd)
        ref = [jnp.asarray(wnt if en else p)
               for p, wnt, en in zip(planes, want, enables)]
        for pic, r in zip(pad_picture(*outs, h, w, True),
                          PL._pad_out(*ref, h, w, True, PAD_L), strict=True):
            np.testing.assert_array_equal(pic.numpy(), np.asarray(r))


def test_alf_params_equal_jax_pack(fixtures_dir):
    """On every frame of a 10-bit ALF stream with ADDB and SUCO (m10_all)."""
    name, w, h, n, qp, seed, gop, tools, bd = (
        "m10_all", 176, 144, 5, 31, 804, "RA",
        ("dra", "alf", "addb", "htdf", "eipd", "cm_init", "iqt", "ats",
         "admvp", "hmvp", "mmvd", "amvr", "btt", "suco", "adcc"), 10)
    stream = _stream(fixtures_dir, f"main_{name}", w, h, n, qp, seed, gop,
                     bd, profile=1, tools=tools)
    seen = 0
    for job, sps, _, pf in captured_frames(stream):
        if job.alf_param is None:
            continue
        cl, cc, on, cfg = PK.alf_params(job.fs, job)
        jl, jc = JA.recon_coef_arrays(
            job.alf_param, job.alf_enable[1] or job.alf_enable[2])
        np.testing.assert_array_equal(cl, jl)
        np.testing.assert_array_equal(cc, jc)
        np.testing.assert_array_equal(on, job.fs.alf_ctu_on.astype(np.int32))
        assert cfg == (tuple(job.alf_enable), job.alf_misc[0],
                       bool(job.alf_misc[1]))
        assert pf.alf == cfg and pf.addb
        seen += 1
    assert seen >= 2


@pytest.mark.parametrize("name,w,h,n,qp,seed,gop,tools,bd,frames", CASES)
def test_torch_main_alf_equals_jax_and_numpy(
        fixtures_dir, tmp_path, name, w, h, n, qp, seed, gop, tools, bd,
        frames):
    assert_backends_agree(fixtures_dir, tmp_path, f"main_{name}", w, h, n, qp,
                          seed, gop, bd, profile=1, tools=tools,
                          frames=frames)
