"""The profile tool's trace arithmetic (xevd_tpu_torch/profile.py), on a
hand-made chrome trace; and its refusal to measure without a CUDA device."""
import json

import pytest
import torch

from xevd_tpu_torch import profile as P


def _trace(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_device_activity_is_the_union_of_device_spans(tmp_path):
    ev = [
        # two overlapping kernels (1000-3000 us), a copy inside them,
        # a memset after a gap, and host events that must not count
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1000, "dur": 1500},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 2000, "dur": 1000},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1200,
         "dur": 100},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 5000,
         "dur": 500},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0,
         "dur": 9000},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 7000},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 8000, "dur": 250},
    ]
    active, by_name = P.device_activity(_trace(tmp_path, ev))
    assert active == pytest.approx(2.0 + 0.5 + 0.25)
    assert by_name["k1"] == [pytest.approx(1.75), 2]
    assert by_name["k2"] == [pytest.approx(1.0), 1]
    assert "aten::add" not in by_name and "marker" not in by_name


def test_profile_refuses_without_cuda(monkeypatch, tmp_path):
    """No card: it raises before decoding anything, never times the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        P.main(["-i", str(tmp_path / "none.evc")])
