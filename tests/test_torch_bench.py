"""The port's benchmark (xevd_tpu_torch/bench.py) on the CPU, at a small
size: its run function on a 64x64 Baseline IPPP stream and a 64x64 Main
stream with ADDB and ALF (plain PyTorch versions), held to the JAX
backend's decode frame by frame, with bench.py's keys and the host split;
its refusal of a decode that differs from the oracle (an altered MD5),
before any number is printed; the GOP batch's part on two 64x64 GOPs
with make_mesh(["cpu"]); the pipeline's stage marks; and its refusal to
run without a card unless asked for the CPU."""
import json

import numpy as np
import pytest
import torch

from xevd_tpu_torch import TorchPixelBackend
from xevd_tpu_torch import bench as B
from xevd_tpu_torch.ops.pipeline import STAGES
from xevd_tpu_torch.parallel import gop as TG

from .test_torch_slice import _decode, _stream

# name, w, h, frames, qp, seed, gop, profile, tools
STREAMS = {
    "baseline_ippp": ("p64", 64, 64, 4, 30, 6, "IPPP", 0, ()),
    "main_addb_alf": ("main_bench_addb_alf64", 64, 64, 3, 30, 1201, "IPPP",
                      1, ("addb", "alf", "eipd", "cm_init", "admvp",
                          "hmvp")),
}
SPLIT_KEYS = ("wall_ms", "decoder_host_ms", "entropy_ms", "derive_ms",
              "pack_ms", "slot_wait_ms", "slot_waits", "upload_host_ms",
              "upload_device_ms", "issue_ms", "device_ms",
              "device_stages_ms", "d2h_wait_ms", "d2h_ms", "note")
STEP_KEYS = ("G", "stage_ms", "copy_issue_ms", "upload_host_ms",
             "step_issue_ms", "upload_device_ms", "wait_device_ms",
             "step_device_ms", "output_device_ms", "itdq_device_ms",
             "mc_device_ms", "recon_device_ms", "intra_device_ms",
             "deblock_device_ms", "pad_device_ms")


def _stream_and_md5s(fixtures_dir, tmp_path, key):
    """A generated stream's bytes and the JAX backend's per-frame 10-bit
    MD5s (its decode cached beside the stream, as the slice tests do)."""
    name, w, h, n, qp, seed, gop, profile, tools = STREAMS[key]
    stream = _stream(fixtures_dir, name, w, h, n, qp, seed, gop,
                     profile=profile, tools=tools)
    jax_out = stream.with_suffix(".jax.yuv")
    if not jax_out.exists():
        rc, out = _decode(stream, tmp_path / "jax.yuv", "jax")
        assert rc == 0
        tmp = jax_out.with_suffix(f".{id(out)}.tmp")
        tmp.write_bytes(out)
        tmp.replace(jax_out)
    return stream.read_bytes(), B.yuv_md5s(jax_out.read_bytes(), w, h)


@pytest.mark.parametrize("key", list(STREAMS))
def test_bench_config_on_cpu_equals_jax(fixtures_dir, tmp_path, key, capsys):
    """run_config on the CPU: every decode equal to JAX's frame by frame,
    one timed run, the host split with its keys and no device number, and
    bench.py's keys in the report."""
    data, md5s = _stream_and_md5s(fixtures_dir, tmp_path, key)
    r = B.run_config(data, md5s, device="cpu", runs=1)
    assert capsys.readouterr().out == ""
    assert r["device"] == "cpu" and r["frames"] == len(md5s)
    assert len(r["fps_runs"]) == 1 and r["fps_median"] > 0
    assert r["fps_min"] == r["fps_max"] == r["fps_median"]
    assert r["smi_before"] is None and r["traced"] is None
    s = r["split"]
    assert set(SPLIT_KEYS) <= set(s)
    assert s["device_ms"] is None and s["upload_device_ms"] is None
    assert s["d2h_wait_ms"] is None
    assert set(s["issue_ms"]) == set(STAGES[2:])
    for k in ("wall_ms", "pack_ms", "upload_host_ms", "d2h_ms"):
        assert s[k] > 0, k
    # the CPU ring has no event to wait on
    assert s["slot_wait_ms"] == 0 and s["slot_waits"] == 0
    # the native engine times its entropy (and Main derive) apart
    assert s["entropy_ms"] > 0 and s["derive_ms"] > 0
    out = B.report({"c3" if STREAMS[key][7] else "c2": r}, None)
    assert set(B.KEYS) <= set(out)
    assert out["device"] == "cpu" and out["card"] is None
    assert out["vs_baseline"] is None and out["ref_fps_best"] is None
    if STREAMS[key][7]:
        assert out["fps_main_1080p_ra"] == r["fps_median"]
        assert out["frames_main"] == len(md5s) and out["value"] is None
    else:
        assert out["value"] == r["fps_median"] and out["frames"] == len(md5s)
        assert out["pack_ms_per_frame"] == s["pack_ms"]
    json.dumps(out)


def test_bench_refuses_an_altered_md5(fixtures_dir, tmp_path, capsys):
    """One oracle MD5 altered: run_config raises OracleMismatch, naming the
    frame, and prints nothing (no timing)."""
    data, md5s = _stream_and_md5s(fixtures_dir, tmp_path, "baseline_ippp")
    bad = list(md5s)
    bad[2] = "0" * 32
    with pytest.raises(B.OracleMismatch, match=r"frames \[2\]"):
        B.run_config(data, bad, device="cpu", runs=1)
    with pytest.raises(B.OracleMismatch, match="4 frames decoded"):
        B.run_config(data, md5s + md5s[:1], device="cpu", runs=1)
    assert capsys.readouterr().out == ""


def test_bench_gop_batch_on_cpu_mesh(fixtures_dir):
    """run_gop on two 64x64 IPPP GOPs (2 and 3 frames) on make_mesh(["cpu"]):
    every call equal to the serial oracle, each step's split (G, the
    copy into its staging slot, the issue of its copies and the
    upload's host time; no device time on the CPU, for the step or for
    any of its stages)."""
    caps = [TG._capture_gop(_stream(fixtures_dir, f"bench_cpu_gop{g}", 64, 64,
                                    2 + g, 30, 1000 + 7 * g, "IPPP")
                            .read_bytes(), oracle=True) for g in range(2)]
    r = B.run_gop(caps, TG.make_mesh(["cpu"]), runs=1)
    assert r["equal"] and r["device"] == "cpu" and r["gops"] == 2
    assert r["frames"] == 5 and r["steps"] == 3
    assert r["batches"] == [[2, 2, 1]]
    assert [s["G"] for s in r["step_split"]] == [2, 2, 1]
    for s in r["step_split"]:
        assert set(s) == set(STEP_KEYS)
        assert s["upload_host_ms"] >= s["stage_ms"] + s["copy_issue_ms"]
        assert s["stage_ms"] > 0 and s["copy_issue_ms"] > 0
        assert s["step_issue_ms"] > 0
        assert s["upload_device_ms"] is s["step_device_ms"] is None
        assert s["output_device_ms"] is s["wait_device_ms"] is None
        assert all(s[f"{k}_device_ms"] is None for k in B.GOP_STAGES)
    assert len(r["fps_runs"]) == 1 and r["fps_median"] > 0
    out = B.report({}, r)
    assert out["fps_gop"] == r["fps_median"] and out["value"] is None
    # a capture whose oracle planes are altered: the batch != the oracle
    bad = [list(c) for c in caps]
    y = bad[1][2]["rec"][0].copy()
    y[0, 0] ^= 1
    bad[1][2] = dict(bad[1][2], rec=(y,) + tuple(bad[1][2]["rec"][1:]))
    with pytest.raises(B.OracleMismatch):
        B.run_gop(bad, TG.make_mesh(["cpu"]), runs=1)


def test_pipeline_marks_pack_then_upload(fixtures_dir):
    """A frame's marks: "start", then STAGES in order ("pack" after the host
    pack, "upload" after its two copies), as the split reads them."""
    data = _stream(fixtures_dir, "i64", 64, 64, 1, 30, 1, "I").read_bytes()
    names = []
    frames, _, _ = B.decode(data, TorchPixelBackend("cpu",
                                                    on_stage=names.append))
    assert len(frames) == 1
    assert STAGES[:2] == ("pack", "upload")
    assert names == ["start", *STAGES]


def test_bench_reports_reference_fps(tmp_path):
    """Where refbin/ holds the reference decoders, their best frames/s of
    -m 1 and -m 8 (bench.py:70-78) fill vs_baseline and vs_ref_main."""
    fake = tmp_path / "xevdb_app"
    fake.write_text('#!/bin/sh\nif [ "$6" = 8 ]; then f=40.0; else f=25.0; '
                    'fi\necho "Average decoding speed = $f frames/sec"\n')
    fake.chmod(0o755)
    assert B.reference_fps(fake, tmp_path / "s.evc") == 40.0
    c = {"fps_median": 20.0, "frames": 16, "fps_runs": [20.0], "fps_min": 20.0,
         "fps_max": 20.0, "host_ms_per_frame_runs": [1.0],
         "split": {"entropy_ms": 1.0, "pack_ms": 2.0}, "device": "cuda",
         "entropy_engine": "native C"}
    out = B.report({"c2": c, "c3": dict(c, fps_median=10.0)}, None,
                   {"c2": 40.0, "c3": 20.0}, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert out["vs_baseline"] == 0.5 and out["ref_fps_best"] == 40.0
    assert out["vs_ref_main"] == 0.5 and out["ref_fps_main_best"] == 20.0
    assert out["total_ms_per_frame"] == 50.0
    assert B.frame_md5((np.zeros((2, 2), np.int16), None, None)) == \
        B.yuv_md5s(bytes(8), 2, 2, chroma=False)[0]


def test_bench_refuses_without_cuda(monkeypatch, capsys):
    """No card and no --device cpu: it raises before any stream is made or
    any number printed; it never times the CPU by default."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(B, "prepare", lambda names: pytest.fail("prepared"))
    with pytest.raises(RuntimeError, match="cuda"):
        B.main(["--only", "c2"])
    assert capsys.readouterr().out == ""
