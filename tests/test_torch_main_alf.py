"""The PyTorch port's ALF (K13 `alf_apply`) on the CPU.

- `ops/alf.py` `alf_frame` (plain versions) equals the JAX `alf_apply` on
  seeded planes, coefficients and CTU flags: 8 and 10 bit (10-bit noise
  makes the classifier's 32-bit products wrap), CTU 64 and 128,
  `across_tiles` 0 and 1, partial CTUs at the right and bottom edges, an
  area larger than the picture (as after ADDB's crop), each plane enabled
  or not;
- the pack's ALF parameters equal the JAX pack's (`recon_coef_arrays`,
  CTU flags, configuration) on the frames of an ALF stream;
- the M8 gate cases, tuples of tests/test_main_profile.py CASES and
  CASES10, decode byte-equal with the torch backend (plain PyTorch
  versions), the JAX backend and the numpy oracle backend; `m_alf_all`
  and `m10_all` are in test_torch_main_full.py, so that the JAX compiles
  spread over the workers of a parallel run.  The cases marked `slow`
  take minutes of JAX compiles (left out of tier-1); `m10_all` runs with
  all of their tools, at 10 bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xevd_tpu.ops import jax_alf as JA
from xevd_tpu_torch.ops import alf as TL
from xevd_tpu_torch.ops import pack as PK

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
    got = [torch.from_numpy(p.copy()) for p in (y, u, v)]
    TL.alf_frame(*got, torch.from_numpy(cl), torch.from_numpy(cc),
                 torch.from_numpy(ctu_on), h, w,
                 (enables, log2_ctu, bool(across)), bd)
    for g, wnt, p, en in zip(got, want, (y, u, v), enables):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
        assert np.array_equal(g.numpy(), p) != en


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
