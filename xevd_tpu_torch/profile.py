"""Where a decode's time goes on the card: wall time of whole decodes
through the port's CLI path, and, from one `torch.profiler` trace, the
union of device activity (kernels, copies, memsets), the device's busy
share of the wall and the device time by kernel or copy name.

    python -m xevd_tpu_torch.profile -i stream.evc

It decodes the stream WARMUP times, then RUNS times timed by the host
clock, then once traced.  Each decode is `xevd_tpu_torch.app.main` with
10-bit output to the null device: entropy, pack, device work, and the
device-to-host copies of the output planes.  The traced decode comes after
the untraced ones, so the profiler's own cost shows as the difference of
their walls.  Needs a CUDA device; prints one JSON object as its last
line."""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import torch

from .app import main as app_main
from .device import resolve_device

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WARMUP = 2
RUNS = 5


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def device_activity(trace_path: str) -> tuple[float, dict]:
    """(union of device intervals in ms, {name: [ms, count]}) from a
    chrome trace written by torch.profiler."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans, by_name = [], defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((ts, ts + dur))
        by_name[e["name"]][0] += dur / 1e3
        by_name[e["name"]][1] += 1
    union, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        union += b - max(a, end)
        end = b
    return union / 1e3, dict(by_name)


def decode_ms(argv) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = app_main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"decode failed: xevd_tpu_torch.app rc {rc}")
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="xevd_tpu_torch.profile")
    ap.add_argument("-i", "--input", required=True, help="input .evc")
    args = ap.parse_args(argv)

    resolve_device("cuda")
    print(card(), flush=True)
    dec = ["-i", args.input, "-o", os.devnull, "--output-bit-depth", "10",
           "-v", "0", "--device", "cuda"]
    for _ in range(WARMUP):
        decode_ms(dec)
    untraced = [decode_ms(dec) for _ in range(RUNS)]
    print("untraced decodes, ms: " + ", ".join(f"{t:.3f}" for t in untraced))

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(activities=acts) as prof:
            traced = decode_ms(dec)
        prof.export_chrome_trace(path)
        active, by_name = device_activity(path)
    if active <= 0:
        raise RuntimeError("the trace holds no device activity")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    print(f"traced decode {traced:.3f} ms; device active {active:.3f} ms "
          f"= {100 * active / traced:.1f} % of the traced wall")
    for name, (ms, n) in top[:12]:
        print(f"  {ms:10.3f} ms  {n:4d}x  {name[:100]}")
    print(json.dumps({
        "card": card(), "untraced_ms": untraced, "traced_ms": traced,
        "device_active_ms": active, "busy_share": active / traced,
        "by_name": {k: {"ms": v[0], "count": v[1]} for k, v in top}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
