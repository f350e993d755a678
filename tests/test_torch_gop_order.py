"""The GOP batch's intra scan order (K15 with K5) on the CPU, exact: the
ticket order the pack ships beside a step's stacked CU table (ops/pack.py
`icu_order`, read by csrc/intra.cu's batched launch) sorts every frame's
rows by their depth in its dependency DAG (`ops/intra.py` `intra_depths`)
and is a topological order of every frame's DAG; the
plain version of the kernel's walk (`ops/intra.py` `intra_scan_ticket_ref`)
equals the frame-after-frame plain version (`intra_scan_batch_ref`, JAX's
semantics) on random causal CIF batches and on real GOP steps; a batched
call off the CPU without the order raises.  The kernel itself is held to
these plain versions in test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

from xevd_tpu.parallel import gop as JG
from xevd_tpu_torch.ops import intra as TI
from xevd_tpu_torch.ops import pack as PK
from xevd_tpu_torch.parallel import gop as TG

from .torch_helpers import (gop_step_cases, intra_batch_scenes,
                            intra_chain_scene, intra_scene, max_abs_err,
                            use_port_native_library)


def _tables(G, seed=40):
    """G random causal CIF CU tables (`intra_batch_scenes`) and their
    stacked rows' offsets."""
    _, _, icu, off, _ = intra_batch_scenes(G, 288, 352, 8, seed=seed)
    return [icu[lo:hi] for lo, hi in zip(off[:-1], off[1:])], off


@pytest.mark.parametrize("G,empty", [(1, ()), (3, ()), (8, ()),
                                     (4, (0, 2)), (3, (2,))])
def test_icu_order_sorts_rows_by_depth(G, empty):
    """A permutation of the stacked rows sorted by (depth in the frame's
    DAG, frame, row): the shallowest rows of every frame first, frame by
    frame, ties in table order.  Frames without CUs (the `empty` ones, as
    a P frame with no intra CU) take no ticket."""
    tables, _ = _tables(G)
    tables = [t[:0] if g in empty else t for g, t in enumerate(tables)]
    counts = [len(t) for t in tables]
    order = PK.icu_order(tables, 72, 88)
    n = sum(counts)
    assert order.dtype == np.int32 and order.shape == (n,)
    np.testing.assert_array_equal(np.sort(order), np.arange(n))
    depth = np.concatenate([TI.intra_depths(t, 72, 88) for t in tables]
                           + [np.zeros(0, np.int64)])
    d = depth[order]
    assert (np.diff(d) >= 0).all()
    assert (np.diff(order)[np.diff(d) == 0] > 0).all()
    frame = np.repeat(np.arange(G), counts)
    assert set(frame[order[d == 1]]) == {g for g in range(G) if counts[g]}


def test_intra_depths_is_the_longest_chain_to_each_row():
    """`intra_depths` on a random causal CIF table and on 4x4 CUs with
    every causal bit set (the longest chains): 1 + the deepest row each
    row waits for (`intra_deps_ref`), 0 for an invalid row, and its
    maximum is `intra_dag_depth`."""
    for icu, hs, ws in ((_tables(1, seed=5)[0][0], 72, 88),
                        (intra_chain_scene(64, 128, 8, 2)[2], 16, 32)):
        deps = TI.intra_deps_ref(torch.from_numpy(icu), hs, ws).numpy()
        want = np.zeros(len(icu) + 1, np.int64)
        for r in range(len(icu)):
            if icu[r, 7] == 1:
                want[r] = 1 + want[deps[r]].max()
        got = TI.intra_depths(icu, hs, ws)
        np.testing.assert_array_equal(got, want[:-1])
        assert TI.intra_dag_depth(icu, hs, ws) == got.max() > 1


def test_intra_depths_host_equals_the_plain_statement():
    """The C pass the pack orders by (`intra_depths_host`,
    native/intra_depths.c) equals `intra_depths` on random causal CIF
    tables (invalid rows among them), 4x4 CUs with every causal bit set
    and an empty table, and raises where it raises: a non-causal table
    (random masks), overlapping CUs, a CU outside the grid."""
    tables, _ = _tables(3, seed=11)
    cases = [(t, 72, 88) for t in tables] + [
        (intra_chain_scene(128, 192, 8, 2)[2], 32, 48),
        (tables[0][:0], 72, 88)]
    for icu, hs, ws in cases:
        np.testing.assert_array_equal(TI.intra_depths_host(icu, hs, ws),
                                      TI.intra_depths(icu, hs, ws))
    assert (tables[0][:, 7] != 1).any()
    bad = intra_scene(288, 352, 8, 3)[2]             # masks not causal
    dup = np.concatenate([tables[0][:5], tables[0][4:5]])
    out = tables[0][:3].copy()
    out[2, 0] = 352
    for icu, what in ((bad, "non-causal"), (dup, "overlap"),
                      (out, "outside")):
        for fn in (TI.intra_depths, TI.intra_depths_host):
            with pytest.raises(ValueError, match=what):
                fn(icu, 72, 88)


def _deps_tickets(icu, off, order, h_scu, w_scu):
    """Per frame, the tickets of each row and of the rows it waits for
    (`intra_deps_ref`, offset to stacked rows; -1 none)."""
    ticket = np.empty(len(order), np.int64)
    ticket[np.asarray(order)] = np.arange(len(order))
    for lo, hi in zip(off[:-1], off[1:]):
        deps = TI.intra_deps_ref(torch.from_numpy(icu[lo:hi]), h_scu,
                                 w_scu).numpy()
        rows = np.repeat(np.arange(lo, hi)[:, None], deps.shape[1], 1)
        on = deps >= 0
        yield ticket[rows[on]], ticket[deps[on] + lo]


@pytest.mark.parametrize("G", [1, 3, 8])
def test_icu_order_is_topological_on_random_batches(G):
    """On G random causal CIF scenes (frames of 384-570 CUs): every row a
    row waits for has a lower ticket -- the invariant that makes the
    batched scan equal decode order and free of deadlock."""
    _, _, icu, off, order = intra_batch_scenes(G, 288, 352, 8, seed=40)
    assert not np.array_equal(order, np.arange(len(order)))
    n_deps = 0
    for t_row, t_dep in _deps_tickets(icu, off, order, 72, 88):
        assert (t_dep < t_row).all()
        n_deps += len(t_row)
    assert n_deps > 0


def _scan_both(recs, res, icu, off, order):
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (icu, off, order)]
    a = [torch.from_numpy(r.copy()) for r in recs]
    b = [torch.from_numpy(r.copy()) for r in recs]
    rs = [torch.from_numpy(r) for r in res]
    TI.intra_scan_ticket_ref(a, rs, t[0], t[1], t[2], 8, True)
    TI.intra_scan_batch_ref(b, rs, t[0], t[1], 8, True)
    return a, b


@pytest.mark.parametrize("G", [1, 3, 8])
def test_ticket_walk_equals_frame_after_frame(G):
    """`intra_scan_ticket_ref` in the pack's order equals
    `intra_scan_batch_ref` on G random causal CIF scenes, and so does the
    wrapper's CPU branch given the order (which walks it)."""
    recs, res, icu, off, order = intra_batch_scenes(G, 288, 352, 8, seed=40)
    a, b = _scan_both(recs, res, icu, off, order)
    assert max_abs_err(a, b) == 0
    assert any(not torch.equal(x, torch.from_numpy(r))
               for x, r in zip(a, recs))
    c = [torch.from_numpy(r.copy()) for r in recs]
    TI.intra_scan(c, [torch.from_numpy(r) for r in res],
                  torch.from_numpy(icu), 8, True,
                  icu_off=torch.from_numpy(off),
                  order=torch.from_numpy(order))
    assert max_abs_err(c, b) == 0


def test_any_topological_order_gives_the_same_planes():
    """Round-robin over the frames by row index (ticket k G' + j is row k
    of the j-th frame that still has one) keeps each frame's table order,
    so it is another topological order: the walk in it equals the
    frame-after-frame scan too, so the result does not depend on which
    such order the pack ships (it ships the DAG-level order, which the
    card runs faster: tests/torch_scan_trace.py)."""
    recs, res, icu, off, level = intra_batch_scenes(3, 288, 352, 8, seed=7)
    counts = np.diff(off)
    k = np.arange(len(icu)) - np.repeat(off[:-1], counts)
    order = np.argsort(k, kind="stable").astype(np.int32)
    assert not np.array_equal(order, level)
    for t_row, t_dep in _deps_tickets(icu, off, order, 72, 88):
        assert (t_dep < t_row).all()
    a, b = _scan_both(recs, res, icu, off, order)
    assert max_abs_err(a, b) == 0


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_batched_scan_without_order_raises_off_the_cpu(device):
    """A batched call without the ticket order raises before any work, on
    the CPU and off it (meta tensors stand in for the card here), as ITDQ
    and MC do without their class orders; nothing falls back.  Off the
    CPU, with the order, the wrapper goes on to the kernel's checks."""
    dev = torch.device(device)
    planes = [torch.zeros(2, 80, 80, dtype=torch.int16, device=dev)
              for _ in range(3)]
    icu = torch.zeros(4, 8, dtype=torch.int32, device=dev)
    off = torch.tensor([0, 2, 4], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="ticket order"):
        TI.intra_scan(planes, planes, icu, 8, True, icu_off=off)
    if device == "meta":
        with pytest.raises(ValueError, match="CUDA"):
            TI.intra_scan(planes, planes, icu, 8, True, icu_off=off,
                          order=torch.arange(4, dtype=torch.int32,
                                             device=dev))


@pytest.fixture(scope="module")
def gop_caps():
    """Four 3-frame 64x64 IPPP GOPs (xevd_tpu/parallel/gop.py
    `gen_gop_streams`), captured by the port's host decoder."""
    use_port_native_library()
    return [TG._capture_gop(s)
            for s in JG.gen_gop_streams(4, w=64, h=64, frames=3)]


@pytest.mark.parametrize("t", [0, 1, 2])
def test_stack_frames_ships_the_ticket_order(gop_caps, t):
    """Each step's batch carries `icu_order` of its stacked CU table (the
    order built from the frames' own tables), uploaded with the batch,
    and it is a topological order of every frame's DAG on the step's own
    tables."""
    _, [(_, steps)] = TG._plan(gop_caps, 1)
    pb = steps[t]
    b = PK.upload_batch(pb, torch.device("cpu"))
    off = b.icu_off.numpy()
    icu = b.icu.numpy()
    np.testing.assert_array_equal(b.icu_order.numpy(), PK.icu_order(
        [icu[lo:hi] for lo, hi in zip(off[:-1], off[1:])], *pb.geom[2:]))
    assert b.icu_order.dtype == torch.int32
    h_scu, w_scu = pb.geom[2:]
    for t_row, t_dep in _deps_tickets(b.icu.numpy(), off, b.icu_order,
                                      h_scu, w_scu):
        assert (t_dep < t_row).all()


@pytest.mark.parametrize("t", [0, 1])
def test_gop_step_cases_on_the_cpu(gop_caps, t):
    """The cases the card's tests and chip_smoke.py run on a GOP step, at
    step 0 (I pictures: no MC case, recon without a prediction) and step
    1, built and run on the CPU: every wrapper (the batched intra scan's
    walk in ticket order, K15's step) equals its batched plain version."""
    cases = gop_step_cases(torch.device("cpu"), gop_caps, t=t)
    names = [c.name for c in cases]
    assert ("mc" in names) == (t > 0)
    assert {"itdq", "recon", "intra_scan", "gop_step"} <= set(names)
    for case in cases:
        assert max_abs_err(case.kernel(), case.plain()) == 0, case.shape
