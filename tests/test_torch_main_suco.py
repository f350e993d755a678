"""The PyTorch port's SUCO-order chroma deblock (K10) on the CPU.

- `chroma_ver_ordered_ref` (the plain version) equals the JAX
  `chroma_ver_ordered` on seeded edge lists at 8 and 10 bit, and the pack's
  per-row edge table (`chroma_ver_edges`) holds the same edges in the same
  order as the JAX pack's waves (`_chroma_ver_waves`) on real SUCO frames;
- the M6 gate cases, tuples of tests/test_main_profile.py CASES that have
  SUCO but neither ADDB nor ALF, decode byte-equal with the torch backend
  (plain PyTorch versions), the JAX backend and the numpy oracle backend.
  They are the first streams that set the right neighbour (LR_01 / LR_11)
  of the EIPD scan.  `m_all_ra` (the same path with B pictures and every
  inter tool) is in test_torch_main_suco_ra.py, so that the JAX compiles
  spread over the workers of a parallel run.  The cases marked `slow`
  take minutes of JAX compiles (left out of tier-1); their tools are
  covered by `m_suco_i`, `m_all_ra` and the existing `m_rpl_p` and
  `m_pocs_ra`."""
import numpy as np
import pytest
import torch

from xevd_tpu.ops import jax_deblock as JD
from xevd_tpu.ops import pipeline as PL
from xevd_tpu_torch.ops import deblock as TD
from xevd_tpu_torch.ops import pack as PK

from .test_torch_slice import _stream, assert_backends_agree
from .torch_helpers import captured_frames, suco_edges

CASES = [
    # name, w, h, frames, qp, seed, gop, tools
    ("m_suco_i", 176, 144, 2, 30, 108, "I",
     ("btt", "suco", "eipd", "cm_init")),
    pytest.param("m_suco_ra", 176, 144, 5, 30, 109, "RA",
                 ("btt", "suco", "eipd", "cm_init"), marks=pytest.mark.slow),
    pytest.param("m_adcc_p", 176, 144, 3, 33, 111, "IPPP",
                 ("btt", "suco", "adcc", "cm_init", "eipd"),
                 marks=pytest.mark.slow),
    pytest.param("m_inter_all", 176, 144, 5, 31, 115, "RA",
                 ("admvp", "hmvp", "mmvd", "amvr", "btt", "suco", "adcc",
                  "cm_init", "eipd"), marks=pytest.mark.slow),
    ("m_ats_p", 176, 144, 3, 32, 118, "IPPP",
     ("iqt", "ats", "admvp", "hmvp", "btt", "suco", "cm_init", "eipd")),
    pytest.param("m_rpl_ra", 176, 144, 9, 30, 901, "RA",
                 ("rpl", "pocs", "eipd", "cm_init", "admvp", "hmvp", "btt",
                  "suco", "adcc"), marks=pytest.mark.slow),
]


def _waves(row_off, edges, h_scu):
    """The JAX schedule of a per-row edge table: wave k = the edge of rank
    k of each row, (row_px, col_px, st_u, st_v), empty slots at 1 << 20."""
    cnt = np.diff(row_off)
    waves = np.full((max(int(cnt.max()), 1), h_scu, 4), 1 << 20, np.int32)
    for r in range(h_scu):
        for k in range(cnt[r]):
            waves[k, r] = (2 * r, *edges[row_off[r] + k])
    return waves


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("seed", [0, 1])
def test_chroma_ver_ordered_plain_equals_jax(bd, seed):
    """Edges in an arbitrary order within each row (also repeated and
    adjacent ones, which cascade), some rows without any."""
    rng = np.random.default_rng(seed + 10 * bd)
    h_scu, w_scu = 12, 20
    u, v = (rng.integers(0, 1 << bd, size=(2 * h_scu, 2 * w_scu))
            .astype(np.int16) for _ in range(2))
    row_off, edges = suco_edges(rng, h_scu, w_scu)
    ju, jv = JD.chroma_ver_ordered(u, v, _waves(row_off, edges, h_scu), bd)
    tu, tv = torch.from_numpy(u.copy()), torch.from_numpy(v.copy())
    TD.chroma_ver_ordered(tu, tv, torch.from_numpy(row_off),
                          torch.from_numpy(edges), bd)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not np.array_equal(tu.numpy(), u)


def test_chroma_ver_edges_equal_jax_waves(fixtures_dir):
    """On every frame of a SUCO stream, the pack's per-row edge table is
    the JAX pack's wave schedule, rank for rank."""
    name, w, h, n, qp, seed, gop, tools = CASES[1].values
    stream = _stream(fixtures_dir, f"main_{name}", w, h, n, qp, seed, gop,
                     profile=1, tools=tools)
    seen = 0
    for job, sps, _, pf in captured_frames(stream):
        got = PK.chroma_ver_edges(job.fs, job)
        want = PL._chroma_ver_waves(job.fs, job)
        assert (got is None) == (want is None)
        if got is None:
            continue
        np.testing.assert_array_equal(_waves(*got, job.fs.h_scu), want)
        assert pf.suco
        seen += 1
    assert seen >= 3


@pytest.mark.parametrize("name,w,h,n,qp,seed,gop,tools", CASES)
def test_torch_main_suco_equals_jax_and_numpy(
        fixtures_dir, tmp_path, name, w, h, n, qp, seed, gop, tools):
    assert_backends_agree(fixtures_dir, tmp_path, f"main_{name}", w, h, n, qp,
                          seed, gop, 8, profile=1, tools=tools)
