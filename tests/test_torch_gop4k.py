"""The GOP batches whose streams are committed (xevd_tpu_torch/streams:
the 8 1080p Baseline IPPP GOPs, gop_<g>.evc and gop.json, and config 5's
one-card half, eight 3840x2160 10-bit Main IPPP GOPs, gop4k_<g>.evc and
gop4k.json) on the CPU, without decoding a 4K picture: each pair matches
its spec (bench.GOP_SPECS, bench.GOP4K_SPECS) -- the SPS parsed by the
port's host copy gives the size, bit depth, profile and tools, and each
GOP has as many pictures as oracle MD5s; the bench takes the committed
pairs, captures each GOP in a worker and refuses a pair whose spec differs;
`--regenerate` writes a pair that the bench then takes (at a stand-in
size); and two 10-bit Main-tap GOPs at 4K's full width, cut short
(3840x64), decode as one batch equal to the port's serial oracle, each
batched kernel's CPU path (the plain versions, the intra scan walking the
batch's ticket order) equal to its batched plain version.  Only against
numpy: tests/test_torch_gop.py holds the 10-bit Main-tap GOP pair to JAX
at 64x64."""
import json
import pickle

import pytest
import torch

from xevd_tpu_torch import bench as B
from xevd_tpu_torch.host import tables as T
from xevd_tpu_torch.host.bitstream import BitReader
from xevd_tpu_torch.host.syntax import parse_nalu_header, parse_sps
from xevd_tpu_torch.parallel import gop as TG

from .test_torch_c4 import SPS_FLAG, TOOLS, _nalus
from .test_torch_slice import _stream
from .torch_helpers import gop_step_cases, max_abs_err

CPU = torch.device("cpu")


def _sps_and_slices(data: bytes):
    sps, slices = None, 0
    for nalu in _nalus(data):
        bs = BitReader(nalu)
        nut = parse_nalu_header(bs).nal_unit_type
        if nut == T.NUT_SPS:
            sps = parse_sps(bs)
        elif nut < T.NUT_SPS:
            slices += 1
    return sps, slices


@pytest.mark.parametrize("name", ["gop", "gop4k"])
def test_committed_gop_pair_matches_its_spec(name):
    """The JSON's spec is bench.GOPS[name]; each GOP's SPS says its size,
    bit depth, profile and tools; one slice a picture, as many pictures as
    the spec's frames and as oracle MD5s, all MD5s distinct."""
    evcs, js = B.gop_pair(name)
    rec = json.loads(js.read_text())
    assert rec["spec"] == json.loads(json.dumps(B.GOPS[name]))
    assert len(evcs) == len(rec["md5s"]) == 8
    for evc, spec, md5s in zip(evcs, rec["spec"], rec["md5s"]):
        w, h, frames, _, _, gop, _, bd, profile, tools, _ = spec
        sps, slices = _sps_and_slices(evc.read_bytes())
        assert (sps.pic_width_in_luma_samples,
                sps.pic_height_in_luma_samples) == (w, h)
        assert sps.bit_depth_luma == sps.bit_depth_chroma == bd
        assert sps.profile_idc == profile and sps.chroma_format_idc == 1
        assert gop == "IPPP"
        for t in TOOLS:
            assert getattr(sps, SPS_FLAG.get(t, f"tool_{t}")) == (t in tools), t
        assert slices == frames == len(md5s)
    assert len({m for md5s in rec["md5s"] for m in md5s}) == \
        sum(len(m) for m in rec["md5s"])
    assert len(rec["encoder_s"]) == len(rec["oracle_s"]) == 8
    assert all(x > 0 for x in rec["encoder_s"] + rec["oracle_s"])
    assert "NumpyPixelBackend" in rec["where"]


def test_gop4k_spec_is_config_5s_one_card_half():
    """8 IDR-led 3840x2160 10-bit Main IPPP GOPs with the four tools the
    GOP batch decodes, of 2 or 3 frames: 20 pictures in 3 steps, step 2
    only the 3-frame GOPs; the 1080p batch keeps its 8 GOPs of 2-4."""
    assert B.MAIN_GOP_TOOLS == ("iqt", "ats", "admvp", "cm_init")
    assert [s[:2] + s[5:] for s in B.GOP4K_SPECS] == \
        [(3840, 2160, "IPPP", 0.3, 10, 1, B.MAIN_GOP_TOOLS, 0.35)] * 8
    frames = [s[2] for s in B.GOP4K_SPECS]
    assert sum(frames) == 20 and max(frames) == 3 and min(frames) == 2
    assert len({s[4] for s in B.GOP4K_SPECS}) == 8
    assert [s[2] for s in B.GOP_SPECS] == [2, 3, 4, 2, 3, 4, 2, 3]
    assert set(B.GOPS) <= set(B.COMMITTED)


@pytest.mark.parametrize("name", ["gop", "gop4k"])
def test_bench_takes_the_committed_gop_pair(monkeypatch, tmp_path, name):
    """prepare() encodes nothing: one capture worker a committed stream
    (here a stand-in that writes a capture of as many frames as the GOP's
    MD5s), the committed MD5s beside the captures; a spec that differs
    from bench.GOPS[name] is refused (regeneration is --regenerate's)."""
    ran = []

    def worker(cmd, what):
        assert cmd[1:4] == ["-m", "xevd_tpu_torch.parallel.gop", "--capture"]
        g = int(what[len(name):])
        ran.append((what, cmd[4]))
        md5s = json.loads(B.gop_pair(name)[1].read_text())["md5s"][g]
        with open(cmd[5], "wb") as f:
            pickle.dump([{"poc": i} for i in range(len(md5s))], f)
        return what, 0, json.dumps({"frames": len(md5s), "seconds": 1.0}), ""
    monkeypatch.setattr(B, "_run_worker", worker)
    monkeypatch.setattr(B, "WORK", tmp_path)
    streams, gops, info = B.prepare([name])
    evcs, js = B.gop_pair(name)
    md5s = json.loads(js.read_text())["md5s"]
    assert streams == {} and set(gops) == {name} and info[name] == "committed"
    assert sorted(ran) == sorted((f"{name}{g}", str(e))
                                 for g, e in enumerate(evcs))
    caps, got = gops[name]
    assert got == md5s and [len(c) for c in caps] == [len(m) for m in md5s]
    # cached by the port's digest: a second prepare starts no worker
    ran.clear()
    assert B.prepare([name])[1][name][1] == md5s and ran == []
    spec = list(B.GOPS[name])
    spec[0] = spec[0][:4] + (spec[0][4] + 1,) + spec[0][5:]
    monkeypatch.setitem(B.GOPS, name, spec)
    with pytest.raises(RuntimeError, match="--regenerate"):
        B.prepare([name])


def test_regenerate_writes_gop_pairs_that_prepare_takes(monkeypatch, tmp_path,
                                                        capsys):
    """`--regenerate --only gop4k` encodes each GOP and decodes it with the
    numpy oracle in reference workers (two 64x64 10-bit Main-tap stand-in
    GOPs of 2 and 3 frames here), writes the streams and the JSON (each
    GOP's MD5s and seconds, the host) and exits; prepare() then captures
    them and run_gop holds the batch to the committed MD5s, an altered one
    raising OracleMismatch."""
    specs = [(64, 64, 2 + g, 32, 1600 + 7 * g, "IPPP", 0.3, 10, 1,
              B.MAIN_GOP_TOOLS, 0.35) for g in range(2)]
    monkeypatch.setitem(B.GOPS, "gop4k", specs)
    monkeypatch.setattr(B, "STREAMS_DIR", tmp_path / "streams")
    monkeypatch.setattr(B, "WORK", tmp_path / "work")
    B.STREAMS_DIR.mkdir()
    assert B.main(["--regenerate", "--only", "gop4k"]) == 0
    rec = json.loads(B.gop_pair("gop4k")[1].read_text())
    assert rec["spec"] == json.loads(json.dumps(specs))
    assert [len(m) for m in rec["md5s"]] == [2, 3]
    assert all(x > 0 for x in rec["encoder_s"] + rec["oracle_s"])
    _, gops, info = B.prepare(["gop4k"])
    caps, md5s = gops["gop4k"]
    assert md5s == rec["md5s"] and info["gop4k0"][-1]["frames"] == 2
    r = B.run_gop(caps, TG.make_mesh(["cpu"]), runs=1, md5s=md5s)
    assert r["equal"] and r["frames"] == 5 and r["batches"] == [[2, 2, 1]]
    assert r["peak_bytes"] is None and r["pinned_bytes"] == 0
    bad = [list(m) for m in md5s]
    bad[1][2] = "0" * 32
    with pytest.raises(B.OracleMismatch, match="committed"):
        B.run_gop(caps, TG.make_mesh(["cpu"]), runs=1, md5s=bad)
    capsys.readouterr()


def test_report_files_gop4k_beside_gop():
    """The 4K batch is the report's "gop4k" entry where it ran; without it
    the report's keys are those of `--only c2,c3,c4,gop`."""
    g = {"fps_median": 100.0, "device": "cuda"}
    keys = set(B.report({}, g))
    assert "gop4k" not in keys and {"gop", "fps_gop", *B.KEYS} <= keys
    out = B.report({}, g, gop4k=dict(g, fps_median=25.0))
    assert set(out) == keys | {"gop4k"}
    assert out["gop4k"]["fps_median"] == 25.0 and out["fps_gop"] == 100.0


def test_gop4k_tools_at_full_width_equal_serial(fixtures_dir):
    """Two 10-bit Main IPPP GOPs with bench.MAIN_GOP_TOOLS at 3840x64 (60
    CTUs a row), of 2 and 3 frames: the port's batch on the CPU (the plain
    versions) equals its serial oracle MD5 for MD5, with the checksum; on
    step 1 each batched kernel's CPU path equals its batched plain version
    (the intra scan's and the step's on copies, as the card's 4K column
    runs them), the scan walking the batch's ticket order."""
    caps = [TG._capture_gop(_stream(
        fixtures_dir, f"gop4k_wide{g}", 3840, 64, 2 + g, 32, 1600 + 7 * g,
        "IPPP", 10, profile=1, tools=B.MAIN_GOP_TOOLS,
        density=0.3).read_bytes(), oracle=True) for g in range(2)]
    assert all(fr["pack"].main_taps and fr["pack"].iqt and fr["pack"].bd == 10
               for c in caps for fr in c)
    stats = {}
    dev, ser = TG.decode_gops_sharded(None, mesh=TG.make_mesh(["cpu"]),
                                      captures=caps, stats=stats)
    assert dev == ser and [len(m) for m in dev] == [2, 3]
    assert stats["checksum"] == stats["serial_checksum"] > 0
    assert stats["batches"] == [[2, 2, 1]] and stats["host_bytes"] > 0
    names = []
    for case in gop_step_cases(CPU, caps, t=1, plain_device=CPU):
        names.append(case.name)
        assert max_abs_err(case.kernel(), case.plain()) == 0, case.name
    assert names == ["itdq", "mc", "recon", "intra_scan", "deblock_luma",
                     "deblock_chroma_ver", "deblock_chroma_hor", "pad",
                     "gop_step"]
