"""The port's host staging (ops/staging.py, the counterpart of the JAX
backend's reused payload buffers) on the CPU: `Packer(buf)` against
`Packer()`; the pack into a ring slot against the fresh pack, frame by
frame, on the Baseline IPPP, Main RA and Main SUCO/ADDB/ALF gate streams;
the CPU upload, which never aliases its slot; `acquire`, which waits on a
slot's event before handing the slot out; whole decodes through rings of
depth 1, 2 and 3 against the JAX backend; the GOP batch, whose steps are
stacked into staging slots, against the serial oracle and JAX's step;
and a kept frame (tests/torch_helpers.py `captured_frames`), which
replays to its own planes after later frames have rewritten its slot.
Every comparison is exact (integer pipelines: byte for byte)."""
import numpy as np
import pytest
import torch

from xevd_tpu.parallel import gop as JG
from xevd_tpu_torch import TorchPixelBackend
from xevd_tpu_torch import bench as B
from xevd_tpu_torch.ops import pack as PK
from xevd_tpu_torch.ops.pipeline import run_frame_device
from xevd_tpu_torch.ops.staging import HostStaging
from xevd_tpu_torch.ops.tables import PAD_C, PAD_L, device_tables
from xevd_tpu_torch.parallel import gop as TG

from .test_torch_gop import CASES as GOP_CASES
from .test_torch_slice import _decode, _stream
from .torch_helpers import captured_frames, use_port_native_library

CPU = torch.device("cpu")
MAIN_ALL = ("iqt", "ats", "admvp", "hmvp", "mmvd", "amvr", "btt", "suco",
            "adcc", "cm_init", "eipd")
# the gate streams of test_torch_slice.py, test_torch_inter_p.py,
# test_torch_inter_ra.py, test_torch_main_suco_ra.py and
# test_torch_main_full.py (their JAX decodes are cached beside them):
# name, w, h, frames, qp, seed, gop, bd, profile, tools
STREAMS = {
    "intra": ("i96x48", 96, 48, 2, 27, 4, "I", 8, 0, ()),
    "ippp": ("p64", 64, 64, 4, 30, 6, "IPPP", 8, 0, ()),
    "ra": ("ra64", 64, 64, 9, 30, 9, "RA", 8, 0, ()),
    "main_ra": ("main_m_all_ra", 176, 144, 5, 31, 119, "RA", 8, 1,
                MAIN_ALL),
    "main_suco_addb_alf": ("main_m10_all", 176, 144, 5, 31, 804, "RA", 10,
                           1, ("dra", "alf", "addb", "htdf") + MAIN_ALL),
}


def _gate(fixtures_dir, tmp_path, key):
    """(stream bytes, the JAX backend's per-frame 10-bit MD5s) of a gate
    stream; JAX's decode is cached beside the stream, as the slice tests
    cache it."""
    name, w, h, n, qp, seed, gop, bd, profile, tools = STREAMS[key]
    stream = _stream(fixtures_dir, name, w, h, n, qp, seed, gop, bd,
                     profile=profile, tools=tools)
    jax_out = stream.with_suffix(".jax.yuv")
    if not jax_out.exists():
        rc, out = _decode(stream, tmp_path / "jax.yuv", "jax")
        assert rc == 0
        tmp = jax_out.with_suffix(f".{id(out)}.tmp")
        tmp.write_bytes(out)
        tmp.replace(jax_out)
    return stream, B.yuv_md5s(jax_out.read_bytes(), w, h)


def _tables(rng, sizes):
    return [(f"t{i}", rng.integers(-9, 9, size=s).astype(np.int64))
            for i, s in enumerate(sizes)]


def _pack(tables, buf=None):
    pk = PK.Packer(buf)
    for name, arr in tables:
        pk.add(name, arr)
    return pk


@pytest.mark.parametrize("case", ["fits", "overflows", "grown"])
def test_packer_with_buffer_equals_packer(case):
    """The same payload bytes and layout with a backing buffer as without:
    when the tables fit (the payload is the buffer's head, nothing
    copied), when they overflow it (concatenated, `overflow` set), and on
    the next frame once the slot has grown by a quarter."""
    rng = np.random.default_rng(7)
    tables = _tables(rng, [(5, 7), (3, 2), (0, 7), (11,), (2, 3, 4)])
    words = sum(a.size for _, a in tables)
    want, want_layout = _pack(tables).finish()
    buf = np.empty(words + (3 if case == "fits" else -5), np.int32)
    if case == "grown":
        slot = HostStaging(CPU, 1).acquire()     # a slot of one word
        pk = _pack(tables, slot.payload_np)
        slot.keep_payload(pk.finish()[0])
        assert pk.overflow and slot.payload.numel() == words + (words >> 2)
        tables = _tables(rng, [(5, 7), (3, 2), (0, 7), (11,), (2, 3, 4)])
        want, want_layout = _pack(tables).finish()
        buf = slot.payload_np
    pk = _pack(tables, buf)
    got, layout = pk.finish()
    assert layout == want_layout
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert pk.overflow == (case == "overflows")
    assert np.shares_memory(got, buf) == (case != "overflows")


@pytest.mark.parametrize("key", ["ippp", "main_ra", "main_suco_addb_alf"])
def test_pack_into_slot_equals_fresh_pack(fixtures_dir, tmp_path, key):
    """Every frame packed into the ring's slot equals the fresh pack of
    the same frame byte for byte (payload, layout, coefficients; ADDB's
    maps, SUCO's edge and run tables, ALF's parameters included), and the
    decode equals JAX's."""
    stream, md5s = _gate(fixtures_dir, tmp_path, key)
    seen = set()

    class TwoPacks(TorchPixelBackend):
        def pack_frame(self, job, sps, refp):
            fresh = PK.pack_frame(job, sps, refp)
            pf = super().pack_frame(job, sps, refp)
            assert pf.slot is not None and fresh.slot is None
            assert np.shares_memory(pf.coefs, pf.slot.coefs_np)
            assert pf.layout == fresh.layout
            assert np.array_equal(pf.payload, fresh.payload)
            assert np.array_equal(pf.coefs, fresh.coefs)
            seen.update(name for name in pf.layout
                        if name in ("addb_l", "suco_runs", "alf_l",
                                    "suco_entries", "dbst", "mc"))
            return pf

    frames, _, _ = B.decode(stream.read_bytes(), TwoPacks("cpu"))
    B.check_frames(frames, md5s, key)
    want = {"ippp": {"dbst", "mc"}, "main_ra": {"dbst", "suco_entries", "mc"},
            "main_suco_addb_alf": {"addb_l", "alf_l", "mc"}}[key]
    assert want <= seen


def test_cpu_upload_does_not_alias_its_slot(fixtures_dir, tmp_path):
    """On the CPU the upload clones: a slot overwritten right after its
    upload leaves the DeviceFrame's tensors unchanged, and the decode
    still equals JAX's."""
    stream, md5s = _gate(fixtures_dir, tmp_path, "ippp")
    checked = []

    class Scribbler(TorchPixelBackend):
        def decode_frame(self, job, sps, refp):
            pf = self.pack_frame(job, sps, refp)
            df = PK.upload(pf, self.device)
            views = (df.tus, df.icu, df.mc, df.dbst, df.coef_y, df.coef_v)
            before = [t.clone() for t in views]
            pf.slot.payload_np[:] = -1
            pf.slot.coefs_np[:] = -1
            assert all(torch.equal(a, b) for a, b in zip(views, before))
            checked.append(pf.payload.size)
            return run_frame_device(df, self.tables)

    frames, _, _ = B.decode(stream.read_bytes(), Scribbler("cpu"))
    B.check_frames(frames, md5s, "scribbled slots")
    assert len(checked) == 4 and min(checked) > 0


class _PendingEvent:
    """A CUDA event stand-in whose copies are still in flight until
    `synchronize`; it notes the slot's bytes when it is waited on."""

    def __init__(self, slot):
        self.slot, self.done, self.seen = slot, False, None

    def query(self):
        return self.done

    def synchronize(self):
        self.seen = self.slot.payload_np[:8].copy()
        self.done = True


def test_acquire_waits_on_the_slot_event():
    """`acquire` hands a slot out only after waiting on its event: the
    event's synchronize is called before the slot comes back, with the
    slot's bytes untouched; a finished event is not waited on."""
    ring = HostStaging(CPU, 2)
    s0 = ring.acquire(payload_words=8)
    s0.payload_np[:8] = np.arange(8)
    s0.event = _PendingEvent(s0)
    s1 = ring.acquire()
    assert s1 is not s0 and s0.event.seen is None and ring.waits == 0
    again = ring.acquire()
    assert again is s0 and ring.waits == 1
    assert np.array_equal(s0.event.seen, np.arange(8))
    s1.event = _PendingEvent(s1)
    s1.event.done = True
    assert ring.acquire() is s1 and s1.event.seen is None
    assert ring.waits == 1 and ring.wait_seconds >= 0


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("key", list(STREAMS))
def test_staged_decode_equals_jax(fixtures_dir, tmp_path, key, depth):
    """A whole decode through `Decoder(backend=TorchPixelBackend("cpu"))`
    with a staging ring of `depth` slots, read behind the CLI's lookahead,
    equals the JAX backend frame by frame (exact), whatever the ring's
    depth."""
    stream, md5s = _gate(fixtures_dir, tmp_path, key)
    backend = TorchPixelBackend("cpu")
    backend.staging = HostStaging(CPU, depth)
    frames, _, _ = B.decode(stream.read_bytes(), backend)
    B.check_frames(frames, md5s, f"{key} at depth {depth}")
    assert backend.staging.waits == 0       # no event on the CPU


@pytest.fixture(scope="module")
def gop_streams():
    """Two of test_torch_gop.py's CASES (tests/test_multichip.py's):
    their streams and JAX's decode_gops_sharded MD5s."""
    use_port_native_library()
    out = {}
    for case in ("2dev_2gop", "4dev_var"):
        n, g, f, v = GOP_CASES[case]
        streams = JG.gen_gop_streams(g, w=64, h=64, frames=f, variable=v)
        out[case] = (n, streams, JG.decode_gops_sharded(
            streams, mesh=JG.make_mesh(n)))
    return out


@pytest.mark.parametrize("case", ["2dev_2gop", "4dev_var"])
def test_gop_batch_stages_every_step(gop_streams, case, monkeypatch):
    """decode_gops_sharded stacks every step into a staging slot of its
    device and uploads from it (clones on the CPU); every frame's MD5
    equals the serial oracle's and JAX's step."""
    n, streams, (jdev, jser) = gop_streams[case]
    staged = []
    upload = PK.upload_batch

    def spy(pb, device, reader=None):
        batch = upload(pb, device, reader)
        assert pb.slot is not None
        assert np.shares_memory(pb.coefs, pb.slot.coefs_np)
        assert not np.shares_memory(batch.coef_y.numpy(), pb.slot.coefs_np)
        staged.append(pb.G)
        return batch

    monkeypatch.setattr(PK, "upload_batch", spy)
    stats = {}
    dev, ser = TG.decode_gops_sharded(streams, mesh=TG.make_mesh(["cpu"] * n),
                                      stats=stats)
    assert dev == ser == jdev == jser
    assert staged == [G for t in range(stats["steps"])
                      for b in stats["batches"] for G in b[t:t + 1]]


def test_kept_frame_replays_after_its_slot_is_rewritten(fixtures_dir,
                                                        tmp_path):
    """A frame `captured_frames` keeps (a copy, detached from its slot)
    replays through the device half to its own decoded planes after the
    whole stream has been decoded through a ring of 2 slots; the kept
    payload no longer shares the slot, which holds a later frame."""
    stream, _ = _gate(fixtures_dir, tmp_path, "ippp")
    kept = captured_frames(stream)
    frames, _, _ = B.decode(stream.read_bytes(), TorchPixelBackend("cpu"))
    tables = device_tables(CPU)
    assert len(kept) == len(frames) == 4
    for (_, _, _, pf), planes in zip(kept, frames):
        assert pf.slot is None
        y, u, v = run_frame_device(PK.upload(pf, CPU), tables)
        h, w = pf.geom[:2]
        got = (y[PAD_L:PAD_L + h, PAD_L:PAD_L + w],
               u[PAD_C:PAD_C + h // 2, PAD_C:PAD_C + w // 2],
               v[PAD_C:PAD_C + h // 2, PAD_C:PAD_C + w // 2])
        assert B.frame_md5(got) == B.frame_md5(planes)
