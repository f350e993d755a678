"""Config 4 (BASELINE.json configs[3], Main 4K 10-bit) on the CPU, without
decoding a 4K picture: the committed stream and oracle MD5s
(xevd_tpu_torch/streams/c4.evc, c4.json) -- the SPS and PPS parsed by the
port's host copy say 3840x2160, 10 bits, the Main profile and the spec's
15 tools; one slice a picture, as many pictures as MD5s; the spec is
bench.CONFIGS["c4"], and the bench takes the pair as it is and refuses
one whose spec differs -- and a wide, short case of c4's tools at its full
width (3840x128, 2 frames, IPPP, 10 bits), decoded by the port's plain
versions and by the numpy oracle, byte-equal.  Only against numpy: a new
JAX shape costs minutes of compiles, and tests/test_torch_main_full.py
`m10_all` holds this tool set to JAX."""
import json

import pytest

from xevd_tpu_torch import bench as B
from xevd_tpu_torch.host import NAL_UNIT_LENGTH_BYTE, info
from xevd_tpu_torch.host import tables as T
from xevd_tpu_torch.host.bitstream import BitReader
from xevd_tpu_torch.host.syntax import parse_nalu_header, parse_pps, parse_sps

from .test_torch_slice import _decode, _stream

# tools/evc_enc.py Tools flag -> the SPS field that carries it
SPS_FLAG = {"btt": "sps_btt_flag", "suco": "sps_suco_flag"}
TOOLS = ("eipd", "cm_init", "btt", "suco", "adcc", "admvp", "hmvp", "mmvd",
         "amvr", "iqt", "ats", "addb", "htdf", "alf", "dra", "affine",
         "dmvr", "rpl", "pocs")


def _nalus(data):
    pos = 0
    while pos + NAL_UNIT_LENGTH_BYTE <= len(data):
        ln, _, _ = info(data[pos:pos + 6])
        yield data[pos + 4:pos + 4 + ln]
        pos += 4 + ln


def test_committed_c4_pair_matches_its_spec():
    evc, js = B.stream_pair("c4")
    rec = json.loads(js.read_text())
    assert rec["spec"] == json.loads(json.dumps(B.CONFIGS["c4"]))
    w, h, _, _, _, gop, _, bd, profile, tools, _ = rec["spec"]
    sps = pps = None
    slices = 0
    for nalu in _nalus(evc.read_bytes()):
        bs = BitReader(nalu)
        nut = parse_nalu_header(bs).nal_unit_type
        if nut == T.NUT_SPS:
            sps = parse_sps(bs)
        elif nut == T.NUT_PPS:
            pps = parse_pps(bs, sps)
        elif nut < T.NUT_SPS:
            slices += 1
    assert (sps.pic_width_in_luma_samples,
            sps.pic_height_in_luma_samples) == (w, h) == (3840, 2160)
    assert sps.bit_depth_luma == sps.bit_depth_chroma == bd == 10
    assert sps.profile_idc == profile == 1 and sps.is_main
    assert sps.chroma_format_idc == 1 and gop == "RA"
    assert len(tools) == 15
    for t in TOOLS:
        assert getattr(sps, SPS_FLAG.get(t, f"tool_{t}")) == (t in tools), t
    assert pps.pic_dra_enabled_flag == 1
    # an I picture and one RA sub-GOP of 4, a slice each, a MD5 each
    assert slices == len(rec["md5s"]) == 5
    assert len(set(rec["md5s"])) == 5
    for k in ("encoder_s", "oracle_s", "where"):
        assert rec[k]


def test_bench_takes_the_committed_pair(monkeypatch):
    """prepare() reads the pair and starts no worker; a spec that differs
    from CONFIGS["c4"] is refused (regeneration is --regenerate's)."""
    monkeypatch.setattr(B, "_run_worker",
                        lambda *a: pytest.fail("a worker started"))
    streams, caps, info_ = B.prepare(["c4"])
    evc, js = B.stream_pair("c4")
    assert info_ == {"c4": "committed"} and caps is None
    assert streams["c4"] == (evc.read_bytes(),
                             json.loads(js.read_text())["md5s"])
    monkeypatch.setitem(B.CONFIGS, "c4", B.CONFIGS["c4"][:4] + (781,)
                        + B.CONFIGS["c4"][5:])
    with pytest.raises(RuntimeError, match="--regenerate"):
        B.prepare(["c4"])


def test_regenerate_writes_a_pair_that_prepare_takes(monkeypatch, tmp_path,
                                                     capsys):
    """`--regenerate` makes the pair anew in a reference worker (a 64x64
    stand-in spec here), writes the stream and its JSON (the oracle's
    MD5s, the seconds, the host) and exits; prepare() then takes it."""
    spec = (64, 64, 2, 30, 17, "IPPP", 0.5, 8, 0, (), 0.35)
    monkeypatch.setitem(B.CONFIGS, "c4", spec)
    monkeypatch.setattr(B, "STREAMS_DIR", tmp_path)
    assert B.main(["--regenerate", "--only", "c4"]) == 0
    evc, js = B.stream_pair("c4")
    rec = json.loads(js.read_text())
    assert rec["spec"] == json.loads(json.dumps(spec))
    assert len(rec["md5s"]) == 2 and rec["encoder_s"] > 0
    assert rec["oracle_s"] > 0 and "NumpyPixelBackend" in rec["where"]
    assert B.prepare(["c4"])[0]["c4"] == (evc.read_bytes(), rec["md5s"])
    capsys.readouterr()


def test_c4_tools_at_full_width_equal_numpy(fixtures_dir, tmp_path):
    """c4's 15 tools at 10 bits on 3840x128 (60 CTUs a row, 2 CTU rows), 2
    IPPP frames: the port's CLI on the CPU and the numpy oracle's decode
    (cached beside the stream: `xevd_tpu` is frozen), byte-equal."""
    w, h = 3840, 128
    stream = _stream(fixtures_dir, "main_c4_wide", w, h, 2, 32, 781, "IPPP",
                     10, profile=1, tools=B.CONFIGS["c4"][9], density=0.3)
    want = stream.with_suffix(".numpy.yuv")
    if not want.exists():
        rc, out = _decode(stream, tmp_path / "numpy.yuv", "numpy")
        assert rc == 0
        tmp = want.with_suffix(f".{id(out)}.tmp")
        tmp.write_bytes(out)
        tmp.replace(want)
    rc, got = _decode(stream, tmp_path / "torch.yuv", "torch")
    assert rc == 0
    assert len(got) == 2 * w * h * 3
    assert got == want.read_bytes()
