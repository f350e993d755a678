"""The benchmark's spans: the marks of each job's steps and, in a traced
run, the device's activity read from a `torch.profiler` chrome trace.

`Marks` is the entry's `on_stage` callback (`parallel/gop.py`
`_DeviceRun.step` calls it at "start", "stage", "copy", "wait", each
stage of `run_frames_device`, "step" and "output" of every step): the
host clock at each mark always; in a traced run also a CUDA event, and
host ranges for the trace (`torch.profiler.record_function`):
"evcbench.decode" from a job's first mark to its last, and
"evcbench.after.<mark>" from each mark to the next, so that an idle gap
on the device can be named by what the host was doing.  The arithmetic
of the intervals is that of `xevd_tpu_torch/bench.py` `StageMarks` and
`gop_step_split`, and the union of device spans that of
`xevd_tpu_torch/profile.py` `device_activity`, copied here."""
from __future__ import annotations

import json
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
DECODE = "evcbench.decode"
AFTER = "evcbench.after."
CALL = "evcbench.call"
CAPTURE = "evcbench.capture"
WINDOW = "evcbench.window"


class Marks:
    """One job's marks: [(name, CUDA event or None, host seconds)]."""

    def __init__(self, traced: bool, cuda: bool, steps: int):
        self.traced, self.cuda, self.steps = traced, cuda, steps
        self.marks = []
        self._ranges = []
        self._outputs = 0

    def __call__(self, name: str):
        ev = None
        if self.traced and self.cuda:
            import torch
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        self.marks.append((name, ev, time.perf_counter()))
        if not self.traced:
            return
        import torch
        if not self._ranges:
            self._open(torch, DECODE)
        else:
            self._close()
        self._outputs += name == "output"
        if self._outputs < self.steps:
            self._open(torch, AFTER + name)
        else:
            self._close()            # the job's decode range

    def _open(self, torch, name):
        r = torch.profiler.record_function(name)
        r.__enter__()
        self._ranges.append(r)

    def _close(self):
        self._ranges.pop().__exit__(None, None, None)

    def steps_marks(self) -> list[dict]:
        """Per step, {mark: (event, host seconds)}."""
        groups = []
        for name, ev, t in self.marks:
            if name == "start":
                groups.append({})
            groups[-1][name] = (ev, t)
        return groups

    def host_ms(self, a: str, b: str) -> float:
        """Host ms from mark a to mark b, summed over the job's steps."""
        return sum((g[b][1] - g[a][1]) * 1e3 for g in self.steps_marks())

    def device_ms(self, a: str, b: str) -> float | None:
        """Event ms from mark a to mark b, summed over the job's steps (None
        without events)."""
        if not (self.traced and self.cuda):
            return None
        return sum(g[a][0].elapsed_time(g[b][0]) for g in self.steps_marks())


def union_us(spans) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


@dataclass
class Trace:
    """A chrome trace read for the benchmark: device spans (start, end,
    name, in a job's decode), host ranges (name, start, end) of the
    benchmark's own spans, and the traced window (start, end), all in
    microseconds of the trace's clock."""
    device: list = field(default_factory=list)
    ranges: list = field(default_factory=list)

    def decode_device(self) -> list:
        return [d for d in self.device if d[3]]

    def busy_us(self, decode_only=False) -> float:
        spans = self.decode_device() if decode_only else self.device
        return union_us((a, b) for a, b, _, _ in spans)

    def window(self) -> tuple:
        return next((a, b) for name, a, b in self.ranges if name == WINDOW)

    def kernel_us(self, kernel: str) -> float:
        """Device microseconds of the kernel named `kernel` (the function's
        name, as a word of the trace's name) in the jobs' decodes."""
        pat = re.compile(rf"(?<![A-Za-z0-9_]){re.escape(kernel)}\b")
        return sum(b - a for a, b, name, _ in self.decode_device()
                   if pat.search(name))

    def device_ops(self, n=10) -> list:
        by = defaultdict(float)
        for a, b, name, _ in self.device:
            by[name] += (b - a) / 1e6
        return sorted(([k[:120], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, t0: float, t1: float, n=10) -> list:
        """The device's idle time in [t0, t1], summed by what the host was
        doing at each gap's middle (the innermost benchmark range there),
        the largest n."""
        merged, end = [], t0
        for a, b, _, _ in sorted(self.device):
            if a > end:
                merged.append((end, a))
            end = max(end, b)
        if t1 > end:
            merged.append((end, t1))
        by = defaultdict(float)
        for a, b in merged:
            mid = (a + b) / 2
            inner = [r for r in self.ranges if r[1] <= mid < r[2]]
            by[_label(min(inner, key=lambda r: r[2] - r[1])[0]
                      if inner else None)] += (b - a) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


def _label(name: str | None) -> str:
    if name in (None, WINDOW):
        return "harness, between jobs"
    if name == CAPTURE:
        return ("host half: the capture workers (parse, entropy, derive, "
                "pack, the numpy decode of every picture)")
    if name == CALL:
        return ("entry outside its clock: plan, allocation, then the MD5s "
                "of outputs and captures")
    if name.startswith(AFTER):
        return f"decode, host after the '{name[len(AFTER):]}' mark"
    return name


def read(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launch, ranges = {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = float(e["ts"])
        elif cat == "user_annotation" and e["name"].startswith("evcbench."):
            ts = float(e["ts"])
            ranges.append((e["name"], ts, ts + float(e.get("dur", 0.0))))
    decodes = sorted((a, b) for name, a, b in ranges if name == DECODE)
    tr = Trace(ranges=ranges)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        ts = float(e["ts"])
        at = launch.get(e.get("args", {}).get("correlation"))
        in_decode = at is not None and any(a <= at <= b for a, b in decodes)
        tr.device.append((ts, ts + float(e.get("dur", 0.0)), e["name"],
                          in_decode))
    return tr
