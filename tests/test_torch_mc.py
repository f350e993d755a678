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
from .torch_helpers import (captured_frames, mc_blocks, mc_class_frame,
                            mc_frame, mc_shapes, recon_pred_planes)

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


def _jax_mc_table(table, refs, shp_y, shp_c, bd, main_taps):
    """JAX's `_mc_all` on an MC block table bucketed by (plane, w, h,
    case), as its packer does (xevd_tpu/ops/pipeline.py `_pack_mc`);
    refs: per slot host (y, u, v) planes."""
    pk = PL._Packer()
    keys = sorted({tuple(int(v) for v in r[:4]) for r in table})
    for plane, w, h, case in keys:
        sel = table[(table[:, PK.MC_PLANE] == plane) & (table[:, PK.MC_W] == w)
                    & (table[:, PK.MC_H] == h)
                    & (table[:, PK.MC_CASE] == case)]
        pk.add(f"m_{'lc'[plane]}_{w}_{h}_{case}",
               sel[:, [PK.MC_SLOT, PK.MC_GX, PK.MC_GY, PK.MC_PY, PK.MC_PX]])
    payload, sig = pk.finish()
    jrefs = tuple(jnp.asarray(np.stack([r[i] for r in refs]))
                  for i in range(3))
    out = PL._mc_all(jnp.asarray(payload), jrefs, sig, shp_y, shp_c, bd,
                     main_taps)
    return [None if o is None else np.asarray(o) for o in out]


def _cta_tiles(o):
    """The (order entry, x0, y0) tiles the kernel's threads take, as
    csrc/mc.cu maps them, and each entry's (Q, R): in each list's launch,
    CTA b's class is the last whose first CTA is <= b; a block takes T =
    w h / (Q R) threads, thread i of the CTA block (b - first CTA) * 256 /
    T + i / T of the class while below its count, and tile i mod T of it,
    w / Q tiles a row."""
    tiles, qr = [], {}
    for k0, n_cls, n_cta in o.lists:
        cls = o.classes[k0:k0 + n_cls]
        for b in range(n_cta):
            k = np.searchsorted(cls[:, 0], b, side="right") - 1
            cta0, ord0, count, shape = (int(v) for v in cls[k])
            lh, lw = (shape >> 2) & 7, (shape >> 5) & 7
            lr, lq = (shape >> 8) & 7, (shape >> 11) & 3
            lt = lw - lq + lh - lr
            for i in range(PK.MC_THREADS):
                j = ((b - cta0) << (8 - lt)) + (i >> lt)
                if j < count:
                    tile = i & ((1 << lt) - 1)
                    tiles.append((ord0 + j, (tile & ((1 << (lw - lq)) - 1))
                                  << lq, (tile >> (lw - lq)) << lr))
                    qr[ord0 + j] = (1 << lq, 1 << lr)
    return tiles, qr


def _mc_tiles_ref(table, o, refs, shp_y, shp_c, bd, main_taps):
    """MC as the kernel splits it: each thread's Q x R tile of its block
    (`_cta_tiles`) predicted alone, as a Q x R block at the tile's
    position (`mc_blocks_ref`), added into the planes; refs as
    `mc_all_ref` takes them (every row's frame here is 0)."""
    stacks = [None if refs[0][i] is None else torch.stack([r[i] for r in refs])
              for i in range(3)]
    planes = TM._new_planes(shp_y, shp_c, CPU)
    tiles, qr = _cta_tiles(o)
    groups = {}
    for e, x0, y0 in tiles:
        row = table[o.order[e, 0]]
        groups.setdefault((int(row[PK.MC_PLANE]), int(row[PK.MC_CASE]))
                          + qr[e], []).append((row, x0, y0))
    for (plane, case, q, r), items in groups.items():
        rows = np.array([it[0] for it in items], np.int64)
        x0 = np.array([it[1] for it in items], np.int64)
        y0 = np.array([it[2] for it in items], np.int64)
        fb = 4 if plane == 0 else 5
        sel = torch.from_numpy(rows)
        yy = torch.from_numpy(rows[:, PK.MC_PY] + y0)[:, None, None] + \
            torch.arange(r)[None, :, None]
        xx = torch.from_numpy(rows[:, PK.MC_PX] + x0)[:, None, None] + \
            torch.arange(q)[None, None, :]
        args = (sel[:, PK.MC_SLOT], sel[:, PK.MC_GX] + torch.from_numpy(
            x0 << fb), sel[:, PK.MC_GY] + torch.from_numpy(y0 << fb), case, q,
            r, bd, plane == 0, TAB, main_taps)
        for i in ((0,) if plane == 0 else (1, 2)):
            planes[(0, 2, 3)[i]].index_put_(
                (yy, xx), TM.mc_blocks_ref(stacks[i], *args), accumulate=True)
        planes[1 if plane == 0 else 4].index_put_(
            (yy, xx), torch.ones((), dtype=torch.int8).expand(len(rows), r, q),
            accumulate=True)
    return planes


def _check_mc_order(table, lists, o, frame=None):
    """`mc_order` against its statement: each list's entries a permutation
    of its rows, frame by frame; each row's frame beside it; one class
    entry a (list, frame, class) present, its rows of its plane, size and
    case, with Q = min(w, 4), R = min(h, 4) where the list's launch then
    fits the card at once else min(h, 8), and its CTAs enough for its
    blocks at 256 / (w h / (Q R)) a CTA; every tile of every block taken
    by exactly one thread.
    Returns the number of class entries."""
    n0, n1 = lists
    perm = o.order[:, 0]
    assert sorted(perm[:n0].tolist()) == list(range(n0))
    assert sorted(perm[n0:].tolist()) == list(range(n0, n0 + n1))
    g = np.zeros(len(perm), np.int64) if frame is None else frame
    np.testing.assert_array_equal(o.order[:, 1], g[perm])
    assert (np.diff(o.order[:n0, 1]) >= 0).all()
    assert (np.diff(o.order[n0:, 1]) >= 0).all()
    lidx = (np.arange(len(perm)) >= n0).astype(np.int64)
    assert len(o.classes) == len({(int(a), int(b)) + tuple(int(v) for v in r)
                                  for a, b, r in zip(lidx, g, table[:, :4])})
    assert sum(k for _, k, _ in o.lists) == len(o.classes)
    for k0, n_cls, n_cta in o.lists:
        cls = o.classes[k0:k0 + n_cls]
        hw = 1 << (((cls[:, 3] >> 5) & 7) + ((cls[:, 3] >> 2) & 7))
        q4r4 = np.minimum(1 << ((cls[:, 3] >> 5) & 7), 4) * np.minimum(
            1 << ((cls[:, 3] >> 2) & 7), 4)
        short = (-(-cls[:, 2] // (PK.MC_THREADS * q4r4 // hw))).sum() * \
            PK.MC_THREADS <= PK.MC_CARD_THREADS
        cta = 0
        for cta0, ord0, count, shape in cls:
            rows = table[perm[ord0:ord0 + count]]
            assert len(set(o.order[ord0:ord0 + count, 1])) == 1
            plane, case = shape >> 13, shape & 3
            w, h = 1 << ((shape >> 5) & 7), 1 << ((shape >> 2) & 7)
            q, r = 1 << ((shape >> 11) & 3), 1 << ((shape >> 8) & 7)
            assert (rows[:, PK.MC_PLANE] == plane).all()
            assert (rows[:, PK.MC_W] == w).all()
            assert (rows[:, PK.MC_H] == h).all()
            assert (rows[:, PK.MC_CASE] == case).all()
            assert q == min(w, 4) and r == min(h, 4 if short else 8)
            assert cta0 == cta
            cta += -(-count // (PK.MC_THREADS * q * r // (w * h)))
        assert cta == n_cta
    tiles, qr = _cta_tiles(o)
    want = []
    for e in range(len(perm)):
        q, r = qr[e]
        row = table[perm[e]]
        want += [(e, x, y) for y in range(0, row[PK.MC_H], r)
                 for x in range(0, row[PK.MC_W], q)]
    assert sorted(tiles) == sorted(want)
    return len(o.classes)


@pytest.mark.parametrize("main_taps", [False, True])
@pytest.mark.parametrize("bd", [8, 10])
def test_class_order_fed_to_plain_mc_matches_jax(bd, main_taps, monkeypatch):
    """The kernel's grouping of a table's rows by class (ops/pack.py
    `mc_order`) on a frame of every class (`mc_class_frame`: every plane
    group, size and case in both lists, windows at the reference planes'
    edges, phase 0 under filtering cases, full-range samples): the order
    as `_check_mc_order` states it; then JAX's `_mc_all` equals the plain
    MC fed the table in that order and the plain MC done tile by tile as
    the kernel's threads split the blocks (64x64 blocks over 128 threads
    by rows and column quads); tiles of 4 rows at 8 bits, and at 10 bits
    of 8 rows, as a launch too large for the card at once takes them."""
    if bd == 10:
        monkeypatch.setattr(PK, "MC_CARD_THREADS", 0)
    table, lists, refs, shp_y, shp_c = mc_class_frame(bd, seed=3)
    frame = np.random.default_rng(bd).integers(0, 4, len(table))
    assert _check_mc_order(table, lists, PK.mc_order(table, lists)) == 400
    o = PK.mc_order(table, lists, frame)
    _check_mc_order(table, lists, o, frame)
    trefs = [tuple(torch.from_numpy(p) for p in r) for r in refs]
    want = _jax_mc_table(table, refs, shp_y, shp_c, bd, main_taps)
    got = TM.mc_all_ref(torch.from_numpy(table[o.order[:, 0]]), trefs, shp_y,
                        shp_c, bd, TAB, main_taps)
    _assert_planes_equal(got, want)
    tiled = _mc_tiles_ref(table, o, trefs, shp_y, shp_c, bd, main_taps)
    _assert_planes_equal(tiled, want)
    assert (got[1] == 2).any() and (got[4] == 2).any()


def test_class_order_of_a_stream_frame_matches_jax(fixtures_dir):
    """A Main B frame with ADMVP taps (test_mc_all_matches_jax_on_stream_
    frame's stream): the pack ships `mc_order` of its table beside it
    (uploaded as `DeviceFrame.mc_order`), and the plain MC done tile by
    tile in the kernel's split equals JAX's `_mc_all` on JAX's payload."""
    stream = make_stream(fixtures_dir / "torch_mc_main_m_admvp_ra.evc", 176,
                         144, 5, 30, 113, "RA", profile=1,
                         tools=("admvp", "hmvp", "cm_init", "eipd"))
    frames = [f for f in captured_frames(stream) if f[3].refs]
    job, sps, refp, pf = max(frames, key=lambda f: (f[3].mc_lists[1],
                                                    sum(f[3].mc_lists)))
    df = PK.upload(pf, CPU)
    table = df.mc.numpy()
    o = PK.mc_order(table, pf.mc_lists)
    np.testing.assert_array_equal(df.mc_order.order.numpy(), o.order)
    np.testing.assert_array_equal(df.mc_order.classes.numpy(), o.classes)
    assert df.mc_order.lists == o.lists
    _check_mc_order(table, pf.mc_lists, o)
    want = _jax_mc_all(PL.JaxPixelBackend().pack_frame(job, sps, refp))
    got = _mc_tiles_ref(table, o, pf.refs, pf.shp_y, pf.shp_c, pf.bd,
                        pf.main_taps)
    _assert_planes_equal(got, want)


def test_mc_order_refuses_blocks_outside_its_classes():
    table, lists, _, _, _ = mc_class_frame(8, n=1)
    for col, v in ((PK.MC_W, 128), (PK.MC_H, 6), (PK.MC_CASE, 4),
                   (PK.MC_PLANE, 2)):
        bad = table.copy()
        bad[0, col] = v
        with pytest.raises(ValueError, match="classes"):
            PK.mc_order(bad, lists)
    with pytest.raises(ValueError, match="lists"):
        PK.mc_order(table, (lists[0], lists[1] + 1))


def test_cuda_mc_call_without_class_order_raises():
    """The order is built at pack time (`pack_frame`, `stack_frames`): the
    kernel's wrapper never builds it, and a call without it raises before
    any operand check or launch."""
    fs, job, refp = mc_frame(64, 64, 8, True, seed=2)
    table, lists, refs = PK.pack_mc(fs, job, refp, True)
    shp_y, shp_c = mc_shapes(fs, True)
    with pytest.raises(ValueError, match="class order"):
        TM._mc_cuda(torch.from_numpy(table), lists, refs, shp_y, shp_c, 8,
                    TAB, False, None, None)
