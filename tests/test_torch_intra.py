"""Baseline intra scan of the PyTorch port against the JAX package
(`jax_intra.intra_scan`; exact: integer), and the dependency rule of its
CUDA scan (`intra_deps_ref`): orders other than decode order that respect
it give JAX's planes.  The CUDA kernel is held to the plain version in
test_torch_cuda.py."""
import heapq

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xevd_tpu.ops import jax_intra as JI
from xevd_tpu_torch.ops import intra as TI

from .conftest import make_stream
from .torch_helpers import (captured_frames, intra_chain_scene, intra_scene,
                            planes_before_intra)


def _jax_scan(recs, res, icu, bd, chroma):
    cu = {k: jnp.asarray(icu[:, i]) for i, k in enumerate(
        ("x", "y", "log2", "ipm", "up_mask", "left_mask", "corner",
         "valid"))}
    out = JI.intra_scan(tuple(jnp.asarray(p) for p in recs),
                        tuple(jnp.asarray(p) for p in res), cu, bd, chroma)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("H,W", [(64, 64), (48, 96)])
@pytest.mark.parametrize("bd", [8, 10])
def test_intra_scan_matches_jax(H, W, bd):
    recs, res, icu = intra_scene(H, W, bd, seed=H * W + bd)
    want = _jax_scan(recs, res, icu, bd, True)
    got = TI.intra_scan([torch.from_numpy(p.copy()) for p in recs],
                        [torch.from_numpy(p) for p in res],
                        torch.from_numpy(icu), bd, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_intra_scan_luma_only_matches_jax():
    recs, res, icu = intra_scene(64, 64, 8, seed=11)
    want = _jax_scan(recs, res, icu, 8, False)
    got = TI.intra_scan([torch.from_numpy(p.copy()) for p in recs],
                        [torch.from_numpy(p) for p in res],
                        torch.from_numpy(icu), 8, False)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), recs[1])   # untouched


def _random_order(deps, seed):
    """A seeded random order of the rows in which every row follows the
    rows it waits for (`deps`, as `intra_deps_ref` gives them)."""
    rng = np.random.default_rng(seed)
    n = deps.shape[0]
    need = [{int(w) for w in d if w >= 0} for d in deps.tolist()]
    waiters = [[] for _ in range(n)]
    for r, ws in enumerate(need):
        for w in ws:
            waiters[w].append(r)
    left = [len(ws) for ws in need]
    pri = rng.random(n)
    ready = [(pri[r], r) for r in range(n) if left[r] == 0]
    heapq.heapify(ready)
    order = []
    while ready:
        _, r = heapq.heappop(ready)
        order.append(r)
        for c in waiters[r]:
            left[c] -= 1
            if left[c] == 0:
                heapq.heappush(ready, (pri[c], c))
    assert len(order) == n
    return order


def _assert_dependency_orders_match(recs, res, icu, bd, h_scu, w_scu,
                                    want, orders=3):
    """Decode order and `orders` random dependency-respecting orders of the
    per-CU step all give `want` (JAX's scan)."""
    deps = TI.intra_deps_ref(icu, h_scu, w_scu)
    rows = torch.as_tensor(icu).tolist()
    n = len(rows)
    for seed in range(-1, orders):
        order = list(range(n)) if seed < 0 else _random_order(deps, seed)
        if seed >= 0 and n > 2:
            assert order != list(range(n))
        got = [torch.as_tensor(np.asarray(p)).clone() for p in recs]
        rt = [torch.as_tensor(np.asarray(p)) for p in res]
        for r in order:
            TI.intra_cu_ref(got, rt, rows[r], bd, True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w,
                                          err_msg=f"order seed {seed}")


@pytest.mark.parametrize("scene,H,W,bd", [("causal", 64, 64, 8),
                                          ("causal", 48, 96, 10),
                                          ("chain", 64, 64, 8)])
def test_dependency_orders_match_jax_on_scene(scene, H, W, bd):
    """The CUDA scan's rule (`intra_deps_ref`): any order in which each CU
    follows the CUs that wrote the cells its masks name gives JAX's planes;
    random causal masks, and the 4x4 chain with every causal bit set."""
    if scene == "causal":
        recs, res, icu = intra_scene(H, W, bd, seed=H + W + bd, causal=True)
    else:
        recs, res, icu = intra_chain_scene(H, W, bd, seed=5)
    want = _jax_scan(recs, res, icu, bd, True)
    _assert_dependency_orders_match(recs, res, icu, bd, H >> 2, W >> 2, want)


@pytest.mark.parametrize("kind", ["intra", "P"])
def test_dependency_orders_match_jax_on_stream_frame(fixtures_dir, kind):
    """The same on a Baseline IPPP gate stream's intra frame and on its P
    frame with the most intra CUs, from the planes after ITDQ, MC and
    recon (the stream of test_torch_inter_p.py's p176x144 case)."""
    stream = make_stream(fixtures_dir / "torch_p176x144.evc", 176, 144, 4, 35,
                         7, "IPPP")
    frames = [f[3] for f in captured_frames(stream)]
    if kind == "intra":
        pf = frames[0]
        assert not pf.refs
    else:
        pf = max((f for f in frames if f.refs),
                 key=lambda f: f.layout["icu"][1][0])
    recs, resids, df = planes_before_intra(pf, torch.device("cpu"))
    icu = df.icu.numpy()
    assert len(icu) > 0
    want = _jax_scan([r.numpy() for r in recs], [r.numpy() for r in resids],
                     icu, pf.bd, True)
    _assert_dependency_orders_match(recs, resids, icu, pf.bd, *pf.geom[2:],
                                    want)


def test_intra_deps_ref_refuses_what_the_scan_cannot_follow():
    """Random masks name cells of later CUs: refused; overlapping CUs and a
    CU outside the grid too.  The causal table's dependencies are the
    writers of the cells its masks name."""
    recs, res, icu = intra_scene(64, 64, 8, seed=3)
    with pytest.raises(ValueError, match="non-causal"):
        TI.intra_deps_ref(icu, 16, 16)
    recs, res, icu = intra_scene(64, 64, 8, seed=3, causal=True)
    deps = TI.intra_deps_ref(icu, 16, 16)
    assert (deps < torch.arange(len(icu))[:, None]).all()
    with pytest.raises(ValueError, match="overlap"):
        TI.intra_deps_ref(np.concatenate([icu, icu[-1:]]), 16, 16)
    with pytest.raises(ValueError, match="outside"):
        TI.intra_deps_ref(icu, 8, 16)
    one = np.array([[0, 0, 3, 0, -1, -1, 1, 1], [8, 0, 3, 0, 0, 1, 0, 1]],
                   np.int32)           # row 1's left cells: row 0 wrote them
    deps = TI.intra_deps_ref(one, 4, 4)
    assert deps[0].max() == -1 and set(deps[1].tolist()) == {-1, 0}
