"""The GOP batch's host half (xevd_tpu_torch/parallel/gop.py `_capture_gop`)
on the CPU: the capture packs each picture and decodes no pixel, its packs
equal the oracle capture's (`oracle=True`, which also decodes each picture
with the numpy oracle) field by field, and `decode_gops_sharded` does its
serial check only where the captures hold the oracle's planes, and hashes
the outputs without a copy (`entry.md5.*`); the counters
`capture.pictures` and `capture.oracle_pictures` and the
benchmark's reader of them (evcbench/metrics/capture_oracle_pct.py)."""
import dataclasses
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from evcbench import spec
from xevd_tpu_torch import spans as SP
from xevd_tpu_torch.bench import MAIN_GOP_TOOLS
from xevd_tpu_torch.host import Decoder, native
from xevd_tpu_torch.ops.pack import PackedFrame
from xevd_tpu_torch.parallel import gop as TG

from .test_torch_gop_md5 import _kept_md5

REPO = Path(__file__).resolve().parent.parent
MESH = TG.make_mesh(["cpu"])
KINDS = ("baseline", "main10")


def _encode(kind, seed, n=3):
    """A 64x64 IPPP GOP of n pictures: Baseline 8-bit, or 10-bit Main with
    the Main taps (bench.MAIN_GOP_TOOLS)."""
    sys.path.insert(0, str(REPO / "tools"))
    import evc_enc
    if kind == "baseline":
        return evc_enc.encode_stream(64, 64, n, 30, seed, "IPPP", 0.5)
    return evc_enc.encode_stream(
        64, 64, n, 30, seed, "IPPP", 0.5, bd=10, profile=1,
        tools=evc_enc.Tools(**{k: 1 for k in MAIN_GOP_TOOLS}))


@pytest.fixture(scope="module")
def gops():
    """Per kind, two GOPs of 3 and 2 pictures."""
    native.get_lib()                  # as each capture worker does first
    return {k: [_encode(k, 1000 + 7 * g, 3 - g) for g in range(2)]
            for k in KINDS}


def _same(a, b):
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("kind", KINDS)
def test_pixel_free_packs_equal_the_oracle_captures(gops, kind):
    for data in gops[kind]:
        free = TG._capture_gop(data)
        oracle = TG._capture_gop(data, oracle=True)
        assert len(free) == len(oracle) > 0
        for f, o in zip(free, oracle):
            assert f["poc"] == o["poc"]
            for field in dataclasses.fields(PackedFrame):
                got = getattr(f["pack"], field.name)
                assert _same(got, getattr(o["pack"], field.name)), field.name
        assert any(f["pack"].ref_pocs for f in free[1:])
        assert all(f["pack"].refs == () for f in free)
    if kind == "main10":
        assert all(f["pack"].main_taps and f["pack"].bd == 10 for f in free)


@pytest.mark.parametrize("kind", KINDS)
def test_pixel_free_capture_holds_no_pixels(gops, kind):
    data = gops[kind][0]
    cap = TG._capture_gop(data)
    assert [sorted(fr) for fr in cap] == [["pack", "poc", "spans"],
                                         ["pack", "poc"], ["pack", "poc"]]
    made = cap[0]["spans"]
    names = {s.name for s in made.spans}
    assert "capture.pack" in names and not any(
        n.startswith("capture.numpy") for n in names)
    assert made.counts == {"capture.pictures": 3}
    oracle = TG._capture_gop(data, oracle=True)
    assert all(fr["rec"][0].dtype == np.int16 for fr in oracle)
    assert oracle[0]["spans"].counts == {"capture.pictures": 3,
                                         "capture.oracle_pictures": 3}


def test_pixel_free_planes_raise_when_a_sample_is_read(gops):
    """The decoder's DPB keeps placeholder planes of the pad-expanded
    shapes, which the capture never read (else it would have raised): a
    read of a sample, as the output of a picture makes, raises."""
    cap = TG._Capture()
    dec = cap.dec = Decoder(backend=cap)
    for nalu in TG._nalu_walk(gops["baseline"][0]):
        dec.decode(nalu)
    assert len(cap.frames) == 3
    pic = dec.last_pic
    assert isinstance(pic.y, TG._NoPixels)
    assert pic.y.shape == (64 + 2 * TG.PAD_L, 64 + 2 * TG.PAD_L)
    assert pic.u.shape == pic.v.shape == (32 + 2 * TG.PAD_C,
                                          32 + 2 * TG.PAD_C)
    for read in (lambda: pic.y[0, 0], lambda: np.asarray(pic.u),
                 lambda: list(pic.v), dec.pull):
        with pytest.raises(RuntimeError, match="no pixels"):
            read()


@pytest.mark.parametrize("kind", KINDS)
def test_entry_over_pixel_free_captures_does_no_serial_work(gops, kind):
    oracle = [TG._capture_gop(g, oracle=True) for g in gops[kind]]
    want_stats = {}
    want, ser = TG.decode_gops_sharded(None, mesh=MESH, captures=oracle,
                                       stats=want_stats)
    assert want == ser
    free = [TG._capture_gop(g) for g in gops[kind]]
    stats = {}
    dev, none = TG.decode_gops_sharded(None, mesh=MESH, captures=free,
                                       stats=stats)
    assert none is None and "serial_checksum" not in stats
    assert dev == ser
    assert stats["checksum"] == want_stats["serial_checksum"] > 0
    (rec,) = SP.calls(1)
    names = [s.name for s in rec.spans]
    assert "entry.outputs" in names and "entry.serial" not in names
    assert rec.counts["capture.pictures"] == 5
    assert "capture.oracle_pictures" not in rec.counts
    # the outputs hashed as they are, on the pool: every cropped byte once,
    # none copied; the digests are the kept formula's of the oracle's planes
    assert rec.counts["entry.md5.bytes"] == 5 * 2 * (64 * 64 + 2 * 32 * 32)
    assert rec.counts["entry.md5.copied_bytes"] == 0
    assert rec.counts["entry.md5.threads"] == TG.MD5_THREADS
    assert dev == [[_kept_md5(*fr["rec"], 64, 64) for fr in c]
                   for c in oracle]


def test_stream_path_still_holds_the_batch_to_the_oracle(gops):
    stats = {}
    dev, ser = TG.decode_gops_sharded(gops["main10"], mesh=MESH,
                                      stats=stats)
    assert ser is not None and dev == ser
    assert stats["checksum"] == stats["serial_checksum"] > 0
    (rec,) = SP.calls(1)
    assert sum(s.name == "entry.serial" for s in rec.spans) == 1
    assert rec.counts["capture.pictures"] == \
        rec.counts["capture.oracle_pictures"] == 5
    # the outputs' and the oracle's pictures hashed, each byte once
    assert rec.counts["entry.md5.bytes"] == 2 * 5 * 2 * (64 * 64
                                                         + 2 * 32 * 32)


def test_cli_captures_with_the_oracle_and_prints_its_counters(
        gops, tmp_path, capsys):
    evcs = []
    for g, data in enumerate(gops["baseline"]):
        evcs.append(tmp_path / f"g{g}.evc")
        evcs[-1].write_bytes(data)
    pkl = tmp_path / "g0.pkl"
    assert TG.main(["--capture", str(evcs[0]), str(pkl)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["frames"] == 3
    assert line["counts"] == {"capture.pictures": 3,
                              "capture.oracle_pictures": 3}
    assert line["self_ms"]["capture.numpy"] > 0
    assert TG.main(["--device", "cpu"] + [str(e) for e in evcs]) == 0
    assert "bit-exact (MD5-compared)" in capsys.readouterr().out


@pytest.mark.parametrize("captures,want", [
    ("pixel_free", 0.0), ("oracle", 100.0), ("no_counter", None)])
def test_capture_oracle_pct_reads_the_counters(gops, captures, want):
    """The benchmark's reader over a window of two jobs (entry calls):
    0 % on pixel-free captures, 100 % on oracle ones, None where the
    program counts no captured pictures (the recorder's records before
    these counters)."""
    read = spec.metric_reader("capture_oracle_pct")
    for _ in range(2):
        if captures == "no_counter":
            with SP.entry():
                SP.add("stage.bytes", 1)
        else:
            caps = [TG._capture_gop(g, oracle=captures == "oracle")
                    for g in gops["baseline"]]
            TG.decode_gops_sharded(None, mesh=MESH, captures=caps)
    run = types.SimpleNamespace(jobs=[object(), object()])
    assert read(run) == want
    assert read(types.SimpleNamespace(jobs=[])) is None
