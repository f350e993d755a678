"""The metrics' arithmetic on synthetic marks and a synthetic trace."""
import json

import pytest

from evcbench import run, spec, work
from evcbench import trace as T


class Ev:
    """A stand-in CUDA event at a time in ms."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def marks(steps):
    """Marks of `steps` steps, each (host s, event ms) per mark."""
    m = T.Marks(traced=False, cuda=False, steps=len(steps))
    m.traced = m.cuda = True
    for step in steps:
        for name, host, dev in step:
            m.marks.append((name, Ev(dev), host))
    return m


def job(m, seconds, plan_s=0.0, after_s=0.0, capture_s=None):
    return run.Job(order=[0], md5s=[], luma=0, frames=2, seconds=seconds,
                   wall=plan_s + seconds + after_s, plan_s=plan_s, marks=m,
                   host_bytes=0, capture_s=capture_s)


STEP = [("start", 0.000, 0.0), ("stage", 0.004, 0.5), ("copy", 0.005, 3.0),
        ("wait", 0.0051, 5.0), ("itdq", 0.006, 5.5), ("step", 0.007, 7.0),
        ("output", 0.0075, 9.0)]


def test_mark_metrics():
    m = marks([STEP, [(n, h + 1, d + 100) for n, h, d in STEP]])
    r = run.Run(jobs=[job(m, 0.02, 0.1, 1.0, 30.0),
                      job(m, 0.02, 0.3, 2.0, 40.0)],
                trace=None, bounds={}, decode_s=0.04)
    read = spec.metric_reader
    assert read("capture_ms")(r) == pytest.approx(35000.0)
    assert read("gop_fps")(r) == pytest.approx(100.0)
    assert read("entry_plan_ms")(r) == pytest.approx(200.0)
    assert read("entry_after_ms")(r) == pytest.approx(1500.0)
    assert read("stage_ms")(r) == pytest.approx(8.0)
    assert read("upload_wait_ms")(r) == pytest.approx(10.0)
    assert read("step_device_ms")(r) == pytest.approx(4.0)
    assert read("output_copy_ms")(r) == pytest.approx(4.0)
    assert read("intra_scan_ms")(r) is None       # no trace: nothing read
    assert read("device_idle_pct")(r) is None
    assert read("kernels_roofline")(r) is None
    cached = run.Run(jobs=[job(m, 0.02)], trace=None, bounds={},
                     decode_s=0.02)
    assert read("capture_ms")(cached) is None     # no capture timed


def write_trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": T.WINDOW, "ts": 0,
         "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": T.CAPTURE, "ts": 0,
         "dur": 80},
        {"ph": "X", "cat": "user_annotation", "name": T.CALL, "ts": 80,
         "dur": 520},
        {"ph": "X", "cat": "user_annotation", "name": T.DECODE, "ts": 100,
         "dur": 200},
        {"ph": "X", "cat": "user_annotation", "name": T.AFTER + "start",
         "ts": 100, "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 110, "dur": 5, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 120, "dur": 5, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 400, "dur": 5, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::"
         "intra_scan_kernel(short*)", "ts": 200, "dur": 100,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::"
         "itdq_kernel(short const*)", "ts": 250, "dur": 100,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 500,
         "dur": 50, "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 80,
         "dur": 10},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return p


def test_trace_metrics(tmp_path):
    tr = T.read(str(write_trace(tmp_path)))
    assert tr.window() == (0.0, 1000.0)
    assert tr.busy_us() == pytest.approx(210.0)    # 80-90, 200-350, 500-550
    assert tr.busy_us(decode_only=True) == pytest.approx(150.0)
    assert tr.kernel_us("intra_scan_kernel") == pytest.approx(100.0)
    assert tr.kernel_us("scan_kernel") == 0                # whole names
    r = run.Run(jobs=[job(marks([STEP]), 0.0005)], trace=tr,
                bounds={"gop_itdq": 50e-6}, decode_s=0.0005)
    read = spec.metric_reader
    assert read("intra_scan_ms")(r) == pytest.approx(0.1)
    assert read("kernels_roofline")(r) == pytest.approx(50.0)
    assert read("device_idle_pct")(r) == pytest.approx(70.0)
    gaps = dict(tr.idle_gaps(*tr.window()))
    assert sum(gaps.values()) == pytest.approx(790e-6)
    assert gaps["decode, host after the 'start' mark"] == pytest.approx(
        110e-6)
    assert gaps[T._label(T.CAPTURE)] == pytest.approx(80e-6)
    assert gaps[T._label(T.CALL)] == pytest.approx(150e-6)
    assert gaps[T._label(None)] == pytest.approx(450e-6)
    assert tr.device_ops()[0][1] == pytest.approx(100e-6)


def test_union_of_spans():
    assert T.union_us([(0, 10), (5, 20), (30, 40), (32, 35)]) == 30


def test_work_functions_count_each_byte_once():
    import numpy as np
    # a 4x4 and an 8x8 TU: read and written once as int16, the table read
    from xevd_tpu_torch.ops import pack as PK
    t = np.zeros((2, PK.TU_COLS), np.int32)
    t[0, PK.TU_LOG2W] = t[0, PK.TU_LOG2H] = 2
    t[1, PK.TU_LOG2W] = t[1, PK.TU_LOG2H] = 3
    nbytes, ops = work.itdq_work(t, PK)
    assert nbytes == 4 * (16 + 64) + t.size * 4
    assert ops == 2 * 16 * 8 + 4 * 16 + 2 * 64 * 16 + 4 * 64
    assert work.recon_work(2, (8, 8), (4, 4), False) == (
        4 * (128 + 64), 2 * (128 + 64))
    assert work.pad_work(1, 2, 2, False, 1, 1) == (2 * (4 + 16), 0)
    assert work.bound_seconds(3.35e12, 0) == pytest.approx(1.0)
