"""The port's GOP-batched decode (xevd_tpu_torch/parallel/gop.py, K15) on
the CPU: the cases of tests/test_multichip.py with `make_mesh(["cpu"] *
n)`, whose per-frame MD5s must equal the port's serial oracle and
`xevd_tpu.parallel.gop.decode_gops_sharded` on the same streams; each
batched plain stage on the frames of one time step against `jax.vmap` of
its JAX function (exact: integer); and the refusals.  The batched kernels
are held to these plain versions in test_torch_cuda.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xevd_tpu.ops import jax_intra as JI
from xevd_tpu.ops import pipeline as PL
from xevd_tpu.parallel import gop as JG
from xevd_tpu_torch import UnsupportedStream
from xevd_tpu_torch.ops import deblock as TD
from xevd_tpu_torch.ops import intra as TI
from xevd_tpu_torch.ops import itdq as TQ
from xevd_tpu_torch.ops import mc as TM
from xevd_tpu_torch.ops import pack as PK
from xevd_tpu_torch.ops import recon as TR
from xevd_tpu_torch.ops.tables import BORDER, PAD_C, PAD_L, device_tables
from xevd_tpu_torch.parallel import gop as TG

from .torch_helpers import use_port_native_library

TAB = device_tables(torch.device("cpu"))

# name -> (devices, GOPs, frames, variable lengths): tests/test_multichip.py
CASES = {"2dev_2gop": (2, 2, 3, False), "8dev_8gop": (8, 8, 3, False),
         "4dev_8gop_2fr": (4, 8, 2, False), "4dev_var": (4, 4, 2, True)}


@pytest.fixture(scope="module")
def streams():
    return {k: JG.gen_gop_streams(g, w=64, h=64, frames=f, variable=v)
            for k, (_, g, f, v) in CASES.items()}


@pytest.fixture(scope="module")
def jax_md5s(streams):
    """JAX's decode_gops_sharded of every case, once per module, on the
    conftest's 8-device CPU mesh."""
    use_port_native_library()
    assert len(jax.devices()) >= 8
    return {k: JG.decode_gops_sharded(streams[k], mesh=JG.make_mesh(n))
            for k, (n, _, _, _) in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_gop_batch_equals_serial_and_jax(case, streams, jax_md5s):
    """Every frame's MD5 equals the port's serial oracle and JAX's sharded
    decode; the checksum equals the serial planes' sum."""
    n = CASES[case][0]
    stats = {}
    dev, ser = TG.decode_gops_sharded(streams[case],
                                      mesh=TG.make_mesh(["cpu"] * n),
                                      stats=stats)
    jdev, jser = jax_md5s[case]
    assert dev == ser
    assert dev == jdev == jser
    assert stats["checksum"] == stats["serial_checksum"] > 0
    if CASES[case][3]:
        assert [len(g) for g in dev] == [2, 3, 4, 2]
        # on one device a GOP that has ended leaves the batch: the four
        # GOPs, longest first, make batches of 4, 4, 2 and 1 frames
        one = {}
        assert TG.decode_gops_sharded(streams[case], mesh=TG.make_mesh(
            ["cpu"]), stats=one) == (dev, ser)
        assert one["batches"] == [[4, 4, 2, 1]]
        assert one["checksum"] == stats["checksum"]


def test_gop_batch_beyond_32_ring_slots():
    """33 two-frame IPPP GOPs on one device: D x G_dev = 33 DPB pictures,
    more than a frame's 32-entry MC pointer table; batched MC addresses
    the DPB ring by its strides, so the batch takes them, as JAX's step
    does.  Every frame's MD5 equals the serial oracle and JAX's
    decode_gops_sharded on one device."""
    use_port_native_library()
    streams = JG.gen_gop_streams(33, w=64, h=64, frames=2)
    stats = {}
    dev, ser = TG.decode_gops_sharded(streams, mesh=TG.make_mesh(["cpu"]),
                                      stats=stats)
    assert stats["depth"] * 33 > PK.MAX_REF_SLOTS
    assert stats["batches"] == [[33, 33]]
    jdev, jser = JG.decode_gops_sharded(streams, mesh=JG.make_mesh(1))
    assert dev == ser
    assert dev == jdev == jser
    assert stats["checksum"] == stats["serial_checksum"] > 0


def test_gop_batch_finds_references_by_decode_steps_not_poc():
    """The port's step maps a reference to the DPB ring by the decode
    steps back to the picture of its POC (parallel/gop.py `_plan`), not by
    the POC difference: with every captured `poc` and `ref_pocs` doubled
    (an IPPP GOP whose POC steps by 2), every frame's MD5 is unchanged and
    still equals the serial oracle's."""
    use_port_native_library()
    streams = JG.gen_gop_streams(3, w=64, h=64, frames=3, variable=True)
    caps = [TG._capture_gop(s, oracle=True) for s in streams]
    mesh = TG.make_mesh(["cpu"])
    plain = {}
    want = TG.decode_gops_sharded(None, mesh=mesh, captures=caps,
                                  stats=plain)
    doubled = [[dict(fr, poc=2 * fr["poc"], pack=dataclasses.replace(
        fr["pack"], ref_pocs=tuple(2 * p for p in fr["pack"].ref_pocs)))
        for fr in c] for c in caps]
    assert any(fr["pack"].ref_pocs for c in doubled for fr in c)
    stats = {}
    got = TG.decode_gops_sharded(None, mesh=mesh, captures=doubled,
                                 stats=stats)
    assert got == want
    assert got[0] == got[1]
    assert stats["depth"] == plain["depth"]


def _pad(p, pad):
    return np.pad(p, pad, mode="edge")


@pytest.fixture(scope="module")
def step_frames():
    """Four 3-frame IPPP GOPs captured by both packers: the port's
    (`TG._capture_gop`, with the oracle's planes) and JAX's (one sticky packer over all GOPs, as
    its decode_gops_sharded packs them)."""
    use_port_native_library()
    streams = JG.gen_gop_streams(4, w=64, h=64, frames=3)
    packer = PL.JaxPixelBackend()
    for s in streams:
        JG._capture_gop(s, packer, collect=False)
    return ([TG._capture_gop(s, oracle=True) for s in streams],
            [JG._capture_gop(s, packer, collect=True) for s in streams])


def _assert_equal(got, want, what):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert (g is None) == (w is None), (what, i)
        if g is not None:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=f"{what} plane {i}")


@pytest.mark.parametrize("t", [0, 1])
@pytest.mark.parametrize("G", [2, 4])
def test_batched_plain_stages_equal_jax_vmap(G, t, step_frames):
    """Time step t of G GOPs -- the I pictures of step 0 (no MC: recon
    with no prediction) or the P frames of step 1 -- stage by stage: ITDQ,
    MC, recon, the Baseline intra scan (K5, walking the batch's ticket
    order), deblock and pad, each batched plain version against
    `jax.vmap` of its JAX function on the same inputs (JAX's stage
    outputs feed both sides' next stage)."""
    pcaps, jcaps = (c[:G] for c in step_frames)
    D, [(gops, steps)] = TG._plan(pcaps, 1)
    assert gops == list(range(G))
    pb = steps[t]
    batch = PK.upload_batch(pb, torch.device("cpu"))
    h, w, h_scu, w_scu = pb.geom
    bd = pb.bd

    # JAX: the frames' payloads with the slot fields remapped onto the union
    # of POC deltas, and the references stacked by delta (gop.py:142-218)
    frames = [jcaps[g][t] for g in range(G)]
    st = dict(frames[0]["pack"]["static"], has_inter=t > 0)
    per_gop = [[fr["poc"] - s[2] for s in fr["pack"]["slots"]]
               for fr in frames]
    union = sorted({d for ds in per_gop for d in ds})
    payloads = []
    for fr, ds in zip(frames, per_gop):
        pay = fr["pack"]["payload"].copy()
        lut = np.array([union.index(d) for d in ds], np.int32)
        for _, off, shape in st["sig_m"] if ds else ():
            rows = pay[off:off + shape[0] * shape[1]].reshape(shape)
            rows[:, 0] = lut[np.clip(rows[:, 0], 0, len(lut) - 1)]
        payloads.append(pay)
    payloads = jnp.asarray(np.stack(payloads))
    coefs = tuple(jnp.asarray(np.stack([fr["pack"]["coefs"][c]
                                        for fr in frames])) for c in range(3))
    pads = (PAD_L, PAD_C, PAD_C)
    assert bool(union) == (t > 0)
    jrefs = tuple(jnp.asarray(np.stack([np.stack(
        [_pad(jcaps[g][t - d]["rec"][c][:h >> bool(c), :w >> bool(c)],
              pads[c]) for g in range(G)]) for d in union]))
        for c in range(3)) if union else None
    # the port: the DPB ring [D, G, ...] a plane, GOP g's picture d steps
    # back in entry (t - d) % D
    ring = [torch.zeros((D, G) + _pad(pcaps[0][0]["rec"][c][
        :h >> bool(c), :w >> bool(c)], pads[c]).shape, dtype=torch.int16)
        for c in range(3)]
    for d in range(1, D + 1 if t else 1):
        for g in range(G):
            for c in range(3):
                ring[c][(t - d) % D, g] = torch.from_numpy(_pad(
                    pcaps[g][t - d]["rec"][c][:h >> bool(c), :w >> bool(c)],
                    pads[c]))
    prefs = TM.DpbRing(tuple(ring), t)
    shp_y, shp_c = st["shp_y"], st["shp_c"]
    assert (shp_y, shp_c) == (pb.shp_y, pb.shp_c)

    jres = jax.vmap(lambda p, c: PL._itdq_all(
        p, c, st["sig_q"], shp_y, shp_c, bd, st["iqt"]))(payloads, coefs)
    res = TQ.itdq((batch.coef_y, batch.coef_u, batch.coef_v), batch.tus,
                  shp_y, shp_c, bd, TAB, pb.iqt, tu_off=batch.tu_off)
    _assert_equal(res, jres, "itdq")

    if t:
        jpred = jax.vmap(lambda p, r: PL._mc_all(
            p, r, st["sig_m"], shp_y, shp_c, bd, st["main_taps"]),
            in_axes=(0, 1))(payloads, jrefs)
        assert batch.mc.shape[0] > 0
        pred = TM.mc_all(batch.mc, pb.mc_lists, prefs, shp_y, shp_c, bd,
                         TAB, pb.main_taps, mc_off=batch.mc_off)
        _assert_equal(pred, jpred, "mc")
    else:
        # an intra step: JAX's recon reads zero predictions
        # (xevd_tpu/ops/pipeline.py:345-353), the port's reads none
        assert batch.mc.shape[0] == 0
        jpred = tuple(jnp.zeros((G,) + s_, dt) for s_, dt in (
            (shp_y, jnp.int32), (shp_y, jnp.int8), (shp_c, jnp.int32),
            (shp_c, jnp.int32), (shp_c, jnp.int8)))

    t_ = [torch.from_numpy(np.array(x)) for x in (*jres, *jpred)]
    jrecs = tuple(jax.vmap(PL._recon_plane, in_axes=(0, 0, 0, None))(
        jpred[p], jpred[c], jres[r], bd) for p, c, r in ((0, 1, 0), (2, 4, 1),
                                                          (3, 4, 2)))
    recs = [TR.recon(t_[r], bd, *((t_[3 + p], t_[3 + c]) if t else ()))
            for p, c, r in ((0, 1, 0), (2, 4, 1), (3, 4, 2))]
    _assert_equal(recs, jrecs, "recon")

    # each frame's CU table, padded to the longest with invalid rows
    icus = [np.zeros((0, 8), np.int32) if fr["pack"]["icu"] is None
            else fr["pack"]["icu"] for fr in frames]
    n = max(len(x) for x in icus)
    icu = jnp.asarray(np.stack([np.concatenate(
        [x, np.zeros((n - len(x), 8), np.int32)]) for x in icus]))
    keys = ("x", "y", "log2", "ipm", "up_mask", "left_mask", "corner",
            "valid")
    recs = [torch.from_numpy(np.array(x)) for x in jrecs]
    jintra = jax.vmap(lambda r, s, c: JI.intra_scan(   # donates its planes
        r, s, {k: c[:, i] for i, k in enumerate(keys)}, bd, True))(
        tuple(jnp.asarray(r.numpy().copy()) for r in recs), jres, icu)
    TI.intra_scan(recs, t_[:3], batch.icu, bd, True, icu_off=batch.icu_off,
                  order=batch.icu_order)
    _assert_equal(recs, jintra, "intra_scan")

    dbst = jnp.asarray(np.stack([fr["pack"]["dbst"] for fr in frames]))
    geom = st["geom"]
    jareas = jax.vmap(lambda r, s: PL._deblock_finish(
        r, s, None, geom, bd, True, True, PAD_L, False))(jintra, dbst)
    recs = [torch.from_numpy(np.array(x)) for x in jintra]
    H4, W4 = h_scu * 4, w_scu * 4
    areas = [recs[0][:, BORDER:BORDER + H4, BORDER:BORDER + W4]] + [
        r[:, BORDER:BORDER + H4 // 2, BORDER:BORDER + W4 // 2]
        for r in recs[1:]]
    TD.deblock_frame(*areas, batch.dbst, bd)
    _assert_equal(areas, jareas, "deblock")

    jpics = jax.vmap(lambda y, u, v: PL._pad_out(y, u, v, h, w, True,
                                                 PAD_L))(*jareas)
    areas = [torch.from_numpy(np.array(x)) for x in jareas]
    pics = TR.pad_picture(*areas, h, w, True)
    _assert_equal(pics, jpics, "pad")
    out = tuple(torch.zeros_like(p) for p in pics)
    assert TR.pad_picture(*areas, h, w, True, out=out) == out
    _assert_equal(out, jpics, "pad into out")


def _gen(w, h, n, seed, gop="IPPP", bd=8, profile=0, tools=()):
    import evc_enc
    return evc_enc.encode_stream(w, h, n, 30, seed, gop, 0.5, bd=bd,
                                 profile=profile,
                                 tools=evc_enc.Tools(**{k: 1 for k in tools}))


@pytest.fixture(scope="module")
def evc_tools():
    import sys

    from .conftest import REPO
    sys.path.insert(0, str(REPO / "tools"))


MESH = TG.make_mesh(["cpu"] * 2)


@pytest.mark.parametrize("other,match", [
    ({"w": 96}, "size"), ({"bd": 10}, "bit depth")])
def test_refuses_gops_that_differ(evc_tools, other, match):
    """GOPs whose pictures differ in size or bit depth (gop.py:138-141)."""
    a = dict(w=64, h=64, n=2, seed=1001)
    streams = [_gen(**a), _gen(**dict(a, seed=1008, **other))]
    with pytest.raises(UnsupportedStream, match=match):
        TG.decode_gops_sharded(streams, mesh=MESH)


def test_refuses_gops_that_differ_in_chroma_format(evc_tools):
    """A GOP whose pictures are 4:0:0 (its captures so marked) beside a
    4:2:0 one; and 4:0:0 alone."""
    caps = [TG._capture_gop(_gen(64, 64, 2, s)) for s in (1001, 1008)]
    caps[1] = [dict(fr, pack=dataclasses.replace(fr["pack"], chroma=False))
               for fr in caps[1]]
    with pytest.raises(UnsupportedStream, match="chroma format"):
        TG.decode_gops_sharded(None, mesh=MESH, captures=caps)
    with pytest.raises(UnsupportedStream, match="4:2:0"):
        TG.decode_gops_sharded(None, mesh=MESH[:1], captures=caps[1:])


def test_refuses_ra_gops(evc_tools):
    """RA: B pictures reference later pictures (gop.py:150)."""
    streams = [_gen(64, 64, 5, s, "RA") for s in (1001, 1008)]
    with pytest.raises(UnsupportedStream, match="earlier picture"):
        TG.decode_gops_sharded(streams, mesh=MESH)


@pytest.mark.parametrize("tools,what", [
    (("btt", "suco", "eipd", "cm_init"), "SUCO"),
    (("eipd",), "EIPD"),
    (("alf", "eipd", "cm_init"), "ALF"),
    (("addb", "eipd", "cm_init"), "ADDB")])
def test_refuses_main_tools(evc_tools, tools, what):
    """SUCO (gop.py:180), ALF (the step passes alf=None), EIPD and ADDB
    Main streams are refused at their SPS, before any frame."""
    streams = [_gen(64, 64, 2, s, profile=1, tools=tools)
               for s in (1001, 1008)]
    with pytest.raises(UnsupportedStream, match=what):
        TG.decode_gops_sharded(streams, mesh=MESH)


def test_refuses_gops_that_do_not_tile_the_mesh(evc_tools):
    with pytest.raises(ValueError, match="tile"):
        TG.decode_gops_sharded([_gen(64, 64, 2, 1001)], mesh=MESH)


MAIN_TAPS = ("iqt", "ats", "admvp", "cm_init")


@pytest.mark.parametrize("tools,bd", [
    pytest.param((), 8, id="tools0"),
    pytest.param(MAIN_TAPS, 8, id="tools1"),
    pytest.param(MAIN_TAPS, 10, id="tools1-bd10")])
def test_main_gop_pair_equals_serial_and_jax(evc_tools, tools, bd):
    """Two 3-frame 64x64 Main IPPP GOPs, with no tools and with iqt, ATS,
    ADMVP (the Main MC taps in the batched MC) and cm_init, at 8 bits and
    with the taps at 10 bits (config 5's 4K GOPs' tools; the batched
    recon's clip, deblock's tc and the taps' shifts at 10 bits): every
    frame's MD5 equals the port's serial oracle and JAX's
    decode_gops_sharded on a 2-device mesh."""
    use_port_native_library()
    streams = [_gen(64, 64, 3, s, bd=bd, profile=1, tools=tools)
               for s in (1001, 1008)]
    stats = {}
    dev, ser = TG.decode_gops_sharded(streams, mesh=MESH, stats=stats)
    jdev, jser = JG.decode_gops_sharded(streams, mesh=JG.make_mesh(2))
    assert dev == ser
    assert dev == jdev == jser
    assert stats["checksum"] == stats["serial_checksum"] > 0
    pack = TG._capture_gop(streams[0])[1]["pack"]
    assert pack.main_taps == ("admvp" in tools)
    assert pack.iqt == ("iqt" in tools)
    assert pack.bd == bd


def test_stack_frames_ships_the_mc_class_order(step_frames):
    """A GOP step's batch carries `mc_order` of its MC table (list 0 of
    every frame, then list 1) with each row's frame g from the offsets, as
    the batched kernel reads it (no search for the frame on the card)."""
    pcaps = step_frames[0]
    _, [(_, steps)] = TG._plan(pcaps, 1)
    pb = steps[1]
    b = PK.upload_batch(pb, torch.device("cpu"))
    off = b.mc_off.numpy()
    frame = np.concatenate([np.repeat(np.arange(pb.G), np.diff(o))
                            for o in off])
    o = PK.mc_order(b.mc.numpy(), pb.mc_lists, frame)
    np.testing.assert_array_equal(b.mc_order.order.numpy(), o.order)
    np.testing.assert_array_equal(b.mc_order.classes.numpy(), o.classes)
    assert b.mc_order.lists == pb.mc_launch == o.lists
    assert set(b.mc_order.order[:, 1].tolist()) == set(range(pb.G))
