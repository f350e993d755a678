"""The port's benchmark: decoded frames/s of `Decoder(backend=
TorchPixelBackend(device))` on bench.py's 1080p configs 2 and 3, on config
4 (BASELINE.json configs[3], Main 4K 10-bit) and of the GOP batch at
1080p and at config 5's one-card half (BASELINE.json configs[4], Main 4K
10-bit GOPs), every timed frame held to the numpy oracle, with the host's
time split apart.  The counterpart of bench.py:80-219.

    python -m xevd_tpu_torch.bench [--device cuda|cpu] [--runs N]
        [--only c2,c3,c4,gop,gop4k]
    python -m xevd_tpu_torch.bench --regenerate [--only c4,gop,gop4k]

Run it alone, on a host where nothing else has started: the frames/s are
host-bound.  It prints one JSON object as its last line, with bench.py's
keys (`value` and `fps_main_1080p_ra` the median of the runs) and the
card's name and power limit.

Streams.  Config 2 is bench.py's 1080p Baseline IPPP stream (16 frames,
bench.py:22), config 3 its 1080p Main RA stream with the 14 tools
(9 frames, bench.py:28-31), config 4 a 3840x2160 10-bit Main RA stream
with those 14 tools and DRA (5 frames), the GOP batches GOP_SPECS (8
1080p Baseline IPPP GOPs, "gop") and GOP4K_SPECS (8 3840x2160 10-bit Main
IPPP GOPs, "gop4k").  `tests/torch_reference.py`, run as a program of its
own, writes each stream (tools/evc_enc, seeded) under
tests/fixtures/torch_bench_*.evc and decodes it with `xevd_tpu`'s numpy
oracle backend; the oracle's per-frame MD5s are kept beside the stream
(.md5.json).  Config 4's stream takes over half an hour of one core to
encode and a GOP's minutes, so their streams and oracle MD5s are
committed (xevd_tpu_torch/streams: c4.evc and c4.json, <gop>_<g>.evc and
<gop>.json, with the specs, the seconds each took and the host they ran
on) and taken as they are when the spec equals CONFIGS["c4"] or
GOPS[name], refused otherwise; `--regenerate` makes them anew (a worker
each, as for the other configs), rewrites them and exits.  Each GOP is
captured (`python -m xevd_tpu_torch.parallel.gop --capture`: the serial
oracle decode with each frame's pack) under build/bench/, by the port's
digest.  All of it runs in parallel worker processes, at most one a
core, once, and is cached; no timed run starts before every worker has
exited.

A config runs one warm-up decode, `runs` timed decodes, one decode with
the host split and one under torch.profiler.  A decode feeds the stream
NAL by NAL, as bench.py does, and brings every output frame's Y, U and V
to the host as numpy arrays (the D2H copy a user pays for) behind the
CLI's lookahead (app.py `LOOKAHEAD_DEPTH`).  The card is synchronised
before each clock starts and before it stops.  Every decode is held frame
by frame to the oracle's MD5s after its clock stops: a difference raises
`OracleMismatch` before any number is printed.

The host split (one more decode, checked, not part of `value`): entropy
and derive by the decoder's own spans (xevd_tpu_torch/spans.py:
`host.entropy`, the C engine's `decode_slice_native` or `_main` or the
Python `EntropyDecoder`; `host.derive`, `job_from_native`,
`derive_frame_native_main` or `derive_frame`), the pack into a staging
slot (ops/staging.py) and the issue of the two
H2D copies by the host clock between the backend's stage marks, the
host's wait for a slot whose copies were still in flight apart (the
ring's own clock, `HostStaging.wait_seconds`; 0 when the ring never
waits), the copies' and every device stage's time by CUDA events at the
marks (`ops/pipeline.py` STAGES: events before and after the copies; an
interval also holds the host's gaps between launches), the output's
D2H copies after a synchronise (the wait for the card apart), and the
inverse DRA that the host applies to a DRA stream's output planes at pull
time (`host.dra`: `host/ops/dra.py` `apply_dra_inverse`, 0 without
DRA).  Entropy
runs on the decoder's worker thread beside pack and dispatch, so the
shares overlap and do not add up to the wall.  The device's busy share
comes from the traced decode, read by `profile.device_activity`.

A GOP batch: `runs` timed `decode_gops_sharded` calls on the captures
(frames/s from the first upload to the last output), each frame's MD5
held to the serial oracle's and the committed MD5s, the peak device
memory and the pinned host bytes, then one call with each step's marks
(`parallel/gop.py` `_DeviceRun.step`) read apart: the copy of its stacked
arrays into its pinned slot and the issue of its copies (host clock), the
copies on the upload stream and the kernel stream's wait for them
(events), `run_frames_device` and each of its stages, and the output
copies (events).

`--device cpu` runs the plain PyTorch versions on the CPU, for the tests;
its JSON says "device": "cpu" and holds no device time.  Reference frames/s
(`vs_baseline`, ...) are measured only where refbin/ holds the reference
decoders (bench.py's recipe); else they are null.  Nothing is fetched."""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import hashlib
import json
import os
import pickle
import platform
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import spans as SP
from .app import LOOKAHEAD_DEPTH
from .device import resolve_device
from .host import Decoder
from .host.decoder import _LazyPlane
from .host import native as host_native
from .ops.pipeline import GOP_STAGES, STAGES, TorchPixelBackend
from .parallel import gop as TG
from .profile import device_activity

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"      # gitignored stream cache
WORK = REPO / "build" / "bench"             # gitignored
REFERENCE = REPO / "tests" / "torch_reference.py"
STREAMS_DIR = REPO / "xevd_tpu_torch" / "streams"   # committed streams
RUNS = 5
# bench.py's config-3 tools (bench.py:28-30)
MAIN_TOOLS = ("eipd", "cm_init", "btt", "suco", "adcc", "admvp", "hmvp",
              "mmvd", "amvr", "iqt", "ats", "addb", "htdf", "alf")
# tools/evc_enc.encode_stream arguments (w, h, frames, qp, seed, gop,
# density, bd, profile, tools, intra_frac), as bench.py calls it
CONFIGS = {
    "c2": (1920, 1080, 16, 32, 777, "IPPP", 0.3, 8, 0, (), 0.35),
    "c3": (1920, 1080, 9, 32, 779, "RA", 0.3, 8, 1, MAIN_TOOLS, 0.1),
    # config 4, BASELINE.json configs[3]: Main 4K 10-bit, the 14 tools and
    # DRA (tests/test_torch_main_full.py `m10_all`'s set); 3 frames encode
    # to 5 (an I picture and one RA sub-GOP of 4)
    "c4": (3840, 2160, 3, 32, 780, "RA", 0.3, 10, 1, MAIN_TOOLS + ("dra",),
           0.1),
}
# the GOP batches (K15), each GOP's tools/evc_enc.encode_stream arguments.
# The 8 1080p Baseline IPPP GOPs: xevd_tpu/parallel/gop.py
# gen_gop_streams(8, 1920, 1080, frames=2, qp=30, variable=True), 2 + g % 3
# frames each
GOP_SPECS = [(1920, 1080, 2 + g % 3, 30, 1000 + 7 * g, "IPPP", 0.5, 8, 0,
              (), 0.35) for g in range(8)]
# the Main tools the GOP batch decodes (iqt/ATS ITDQ, the ADMVP MC taps):
# parallel/gop.py refuses SUCO, EIPD (and so BTT), ADDB and ALF
MAIN_GOP_TOOLS = ("iqt", "ats", "admvp", "cm_init")
# config 5's one-card half (BASELINE.json configs[4], Main 4K multi-GOP
# batch): eight IDR-led 3840x2160 10-bit Main IPPP GOPs of 2 or 3 frames (20
# pictures in 3 steps; only the 3-frame GOPs reach step 2) at config 2's and
# 4's qp and density
GOP4K_SPECS = [(3840, 2160, 2 + g % 2, 32, 1600 + 7 * g, "IPPP", 0.3, 10, 1,
                MAIN_GOP_TOOLS, 0.35) for g in range(8)]
GOPS = {"gop": GOP_SPECS, "gop4k": GOP4K_SPECS}
# the configs and GOP batches whose streams and oracle MD5s are committed
# (STREAMS_DIR)
COMMITTED = ("c4", "gop", "gop4k")
# bench.py's keys, every one in the last line
KEYS = ("metric", "value", "unit", "vs_baseline", "ref_fps_best", "frames",
        "total_ms_per_frame", "host_ms_per_frame", "entropy_ms_per_frame",
        "pack_ms_per_frame", "fps_main_1080p_ra", "ref_fps_main_best",
        "vs_ref_main", "frames_main")
OVERLAP = ("entropy runs on the decoder's worker thread beside pack and "
           "dispatch: the shares overlap and do not add up to the wall")


class OracleMismatch(AssertionError):
    """A decoded frame differs from the numpy oracle's."""


def log(*a):
    print(*a, flush=True)


def nvidia_smi(query: str) -> str:
    """The first card's answer to `nvidia-smi --query-gpu=QUERY`."""
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _smi_sample(dev) -> str | None:
    return (nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
            if dev.type == "cuda" else None)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def frame_md5(planes) -> str:
    """MD5 of a frame's planes as the 10-bit YUV writer writes them
    (uint16 LE samples, Y then U then V)."""
    m = hashlib.md5()
    for p in planes:
        if p is not None:
            m.update(np.ascontiguousarray(np.asarray(p).astype("<u2"))
                     .tobytes())
    return m.hexdigest()


def yuv_md5s(yuv: bytes, w: int, h: int, chroma: bool = True) -> list[str]:
    """Per-frame MD5s of a 10-bit 4:2:0 (or 4:0:0) YUV file's bytes."""
    fsz = w * h * (3 if chroma else 2)
    if len(yuv) % fsz:
        raise ValueError(f"{len(yuv)} B is not a whole number of {w}x{h} "
                         "frames")
    return [hashlib.md5(yuv[i:i + fsz]).hexdigest()
            for i in range(0, len(yuv), fsz)]


def check_frames(frames, md5s, what):
    """Raise OracleMismatch unless the frames' MD5s equal the oracle's."""
    got = [frame_md5(f) for f in frames]
    if len(got) != len(md5s):
        raise OracleMismatch(f"{what}: {len(got)} frames decoded, the oracle "
                             f"has {len(md5s)}")
    bad = [i for i, (a, b) in enumerate(zip(got, md5s)) if a != b]
    if bad:
        raise OracleMismatch(f"{what}: frames {bad} differ from the numpy "
                             "oracle")


class StageMarks:
    """The `on_stage` callback: (name, CUDA event or None, host clock) a
    mark; events only on a CUDA device."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        self.marks = []

    def __call__(self, name):
        ev = None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        self.marks.append((name, ev, time.perf_counter()))

    def intervals(self):
        """(name, host ms, device ms or None) of each interval that ends at
        a mark other than "start"."""
        return [(name, (t - pt) * 1e3,
                 pev.elapsed_time(ev) if self.cuda else None)
                for (_, pev, pt), (name, ev, t) in zip(self.marks,
                                                       self.marks[1:])
                if name != "start"]


def _release(dec):
    """Finish a decoder's deferred frame and end its entropy thread, so
    that nothing of one decode runs into the next one's clock."""
    dec._drain_pipeline()
    if dec._entropy_pool is not None:
        dec._entropy_pool.shutdown(wait=True)
        dec._entropy_pool = None


def decode(data: bytes, backend, on_output=None, limit=0):
    """Decode a length-prefixed NAL unit stream through `Decoder`, NAL by
    NAL (bench.py:135-155); every output frame's planes reach the host as
    numpy arrays, LOOKAHEAD_DEPTH frames behind the decoder (the CLI's
    order: reading a frame that is still deferred runs its pack and
    dispatch).  `on_output(frame)`, if given, does the read instead.
    `limit`: stop at the first `limit` output frames (0: all).  Returns
    ([(y, u, v) per frame], host seconds inside `Decoder.decode`, the
    decoder's entropy engine)."""
    read = on_output or (lambda f: tuple(
        None if p is None else np.asarray(p) for p in (f.y, f.u, f.v)))
    dec = Decoder(backend=backend)
    pending, frames, host = collections.deque(), [], 0.0

    def full():
        return bool(limit) and len(frames) + len(pending) >= limit
    try:
        for nalu in TG._nalu_walk(data):
            if full():
                break
            t0 = time.perf_counter()
            stat = dec.decode(nalu)
            host += time.perf_counter() - t0
            if stat.fnum >= 0:
                f, _ = dec.pull()
                if f is not None:
                    pending.append(f)
                    if len(pending) > LOOKAHEAD_DEPTH:
                        frames.append(read(pending.popleft()))
        while not full():
            f, _ = dec.pull()
            if f is None:
                break
            pending.append(f)
        frames.extend(read(f) for f in pending)
    finally:
        _release(dec)
    engine = "native C" if dec.use_native_entropy else "python"
    return frames, host, engine


def split_decode(data: bytes, md5s, dev) -> dict:
    """One decode, checked, with the host's time split apart (ms a frame):
    see the module docstring."""
    marks = StageMarks(dev)
    backend = TorchPixelBackend(device=dev, on_stage=marks)
    ring = backend.staging
    wait = copy = 0.0

    def read(f):
        # a frame still deferred runs its pack and dispatch first (timed
        # by the marks), then the card finishes what is queued before the
        # copies (the wait), then the copies
        nonlocal wait, copy
        planes = [p._resolve() if isinstance(p, _LazyPlane) else p
                  for p in (f.y, f.u, f.v)]
        t0 = time.perf_counter()
        _sync(dev)
        t1 = time.perf_counter()
        planes = tuple(None if p is None else np.asarray(p) for p in planes)
        wait += t1 - t0
        copy += time.perf_counter() - t1
        return planes

    # the decoder's own spans: host.entropy (on its pool thread where it
    # runs there), host.derive and host.dra (the inverse DRA at pull time)
    with SP.record() as rec:
        _sync(dev)
        t0 = time.perf_counter()
        frames, host, _ = decode(data, backend, read)
        _sync(dev)
        wall = time.perf_counter() - t0
    check_frames(frames, md5s, "host-split decode")
    n = len(frames)
    host_ms = dict.fromkeys(STAGES, 0.0)
    dev_ms = dict.fromkeys(STAGES, 0.0)
    for name, h, d in marks.intervals():
        host_ms[name] += h
        if d is not None:
            dev_ms[name] += d
    cuda = dev.type == "cuda"
    device_stages = STAGES[2:]
    slot_wait = ring.wait_seconds * 1e3
    return {
        "wall_ms": wall * 1e3 / n,
        "decoder_host_ms": host * 1e3 / n,
        "entropy_ms": SP.self_ms(rec.spans, "host.entropy") / n,
        "derive_ms": SP.self_ms(rec.spans, "host.derive") / n,
        # the pack into the slot, the wait for the slot apart
        "pack_ms": (host_ms["pack"] - slot_wait) / n,
        "slot_wait_ms": slot_wait / n,
        "slot_waits": ring.waits,
        # the issue of the two copies (non-blocking from the pinned slot on
        # a card); their device time by events before and after them
        "upload_host_ms": host_ms["upload"] / n,
        "upload_device_ms": dev_ms["upload"] / n if cuda else None,
        # host clock spent issuing each device stage
        "issue_ms": {s: host_ms[s] / n for s in device_stages},
        "device_ms": ({s: dev_ms[s] / n for s in device_stages} if cuda
                      else None),
        "device_stages_ms": (sum(dev_ms[s] for s in device_stages) / n
                             if cuda else None),
        "d2h_wait_ms": wait * 1e3 / n if cuda else None,
        "d2h_ms": copy * 1e3 / n,
        # the inverse DRA of the output planes on the host, at pull time
        "dra_ms": SP.self_ms(rec.spans, "host.dra") / n,
        "note": OVERLAP,
    }


def traced_decode(data: bytes, md5s, dev) -> dict:
    """One decode, checked, under torch.profiler: the device's busy share
    of the traced wall (union of kernel, copy and memset spans,
    `profile.device_activity`), the copies' device ms, and the device
    time by name (the top 8)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    backend = TorchPixelBackend(device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(activities=acts) as prof:
            _sync(dev)
            t0 = time.perf_counter()
            frames, _, _ = decode(data, backend)
            _sync(dev)
            traced = (time.perf_counter() - t0) * 1e3
        check_frames(frames, md5s, "traced decode")
        prof.export_chrome_trace(path)
        active, by_name = device_activity(path)
    out = {"traced_ms": traced, "device_active_ms": None, "busy_share": None,
           "h2d_ms": None, "d2h_ms": None, "top": None}
    if active <= 0:
        out["note"] = ("the profiler's trace holds no device activity on "
                       "this machine: busy share not measured")
        return out
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    out.update(device_active_ms=active, busy_share=active / traced,
               h2d_ms=sum(ms for k, (ms, _) in by_name.items()
                          if k.startswith("Memcpy HtoD")),
               d2h_ms=sum(ms for k, (ms, _) in by_name.items()
                          if k.startswith("Memcpy DtoH")),
               top=[{"name": k[:80], "ms": ms, "count": c}
                    for k, (ms, c) in top[:8]])
    return out


def _spread(values) -> dict:
    med = statistics.median(values)
    return {"median": med, "min": min(values), "max": max(values),
            "spread": (max(values) - min(values)) / med if med else None}


def run_config(data: bytes, md5s, device="cuda", runs=RUNS) -> dict:
    """One config: a warm-up decode, `runs` timed decodes, the host split
    and (on a card) the traced decode, each held to the oracle's per-frame
    MD5s; raises OracleMismatch on any difference.  Prints nothing."""
    dev = resolve_device(device)
    backend = TorchPixelBackend(device=dev)
    frames, _, engine = decode(data, backend)
    check_frames(frames, md5s, "warm-up decode")
    del frames
    fps, total, host = [], [], []
    load0, smi0 = os.getloadavg(), _smi_sample(dev)
    for r in range(runs):
        _sync(dev)
        t0 = time.perf_counter()
        frames, h, _ = decode(data, backend)
        _sync(dev)
        el = time.perf_counter() - t0
        check_frames(frames, md5s, f"timed decode {r}")
        n = len(frames)
        del frames
        fps.append(n / el)
        total.append(el * 1e3 / n)
        host.append(h * 1e3 / n)
    load1, smi1 = os.getloadavg(), _smi_sample(dev)
    split = split_decode(data, md5s, dev)
    traced = traced_decode(data, md5s, dev) if dev.type == "cuda" else None
    return {"device": dev.type, "frames": len(md5s), "entropy_engine": engine,
            "fps_runs": fps, **{f"fps_{k}": v for k, v in
                                _spread(fps).items()},
            "total_ms_per_frame_runs": total,
            "host_ms_per_frame_runs": host,
            "loadavg_before": load0, "loadavg_after": load1,
            "smi_before": smi0, "smi_after": smi1,
            "split": split, "traced": traced}


def gop_step_split(marks: StageMarks, batches) -> list[dict]:
    """Each step's split from the marks of one `decode_gops_sharded` call
    (step by step, each step device by device, as `_DeviceRun.step` marks
    it): G; `stage_ms`, the copy of its stacked arrays into its pinned
    slot, and `copy_issue_ms`, the issue of its two copies (host clock);
    `upload_host_ms`, from the step's start until its kernels could be
    issued (the two, and the issue of the kernel stream's wait); with
    events, `upload_device_ms`, the copies on the upload stream,
    `wait_device_ms`, the kernel stream's wait from the step's start (the
    end of the previous step's work on it) until the copies had landed,
    `step_device_ms` (`run_frames_device`), `<stage>_device_ms` for each
    of its stages (GOP_STAGES: the interval from the stage before it, or
    from the wait, to the stage's mark; the step's ITDQ, MC, recon,
    Baseline intra scan, deblock and pad read apart), and
    `output_device_ms` (the checksum and the output copies);
    `step_issue_ms`, the host's issue of `run_frames_device`."""
    groups = []
    for name, ev, t in marks.marks:
        if name == "start":
            groups.append({})
        groups[-1][name] = (ev, t)
    if len(groups) != len(batches):
        raise AssertionError(f"{len(groups)} marked steps, {len(batches)} "
                             "batches")

    def host(g, a, b):
        return (g[b][1] - g[a][1]) * 1e3

    def device(g, a, b):
        return g[a][0].elapsed_time(g[b][0]) if marks.cuda else None

    def stages(g):
        return {f"{b}_device_ms": device(g, a, b)
                for a, b in zip(("wait",) + GOP_STAGES, GOP_STAGES)}
    return [{"G": G, "stage_ms": host(g, "start", "stage"),
             "copy_issue_ms": host(g, "stage", "copy"),
             "upload_host_ms": host(g, "start", "wait"),
             "step_issue_ms": host(g, "wait", "step"),
             "upload_device_ms": device(g, "stage", "copy"),
             "wait_device_ms": device(g, "start", "wait"),
             "step_device_ms": device(g, "wait", "step"),
             **stages(g),
             "output_device_ms": device(g, "step", "output")}
            for G, g in zip(batches, groups)]


def run_gop(captures, mesh, runs=RUNS, md5s=None) -> dict:
    """The GOP batch on `captures` (`parallel/gop.py` `_capture_gop`
    results): a warm-up call, `runs` timed `decode_gops_sharded` calls and
    one with each step's staging, copies, wait, `run_frames_device` and
    output copies timed apart (`gop_step_split`; its batch ms `split_ms`,
    the marks' own cost included); every call's frame MD5s and checksum
    held to the serial oracle's, and to `md5s` (the committed oracle MD5s,
    a list a GOP) where given (OracleMismatch).  On a card, the warm-up
    call's peak device memory (`peak_bytes`, torch.cuda.
    max_memory_allocated() from a reset just before it) and the batch's
    pinned host buffers (`pinned_bytes`: the staging slots and the output
    buffers, `_DeviceRun`), both held outside the clock.  Prints
    nothing."""
    cuda = mesh[0].type == "cuda"

    def call(on_stage=None):
        stats = {}
        dmd5, smd5 = TG.decode_gops_sharded(None, mesh=mesh,
                                            captures=captures, stats=stats,
                                            on_stage=on_stage)
        if dmd5 != smd5 or stats["checksum"] != stats["serial_checksum"]:
            raise OracleMismatch("GOP batch: a frame's MD5 differs from the "
                                 "serial numpy oracle's")
        if md5s is not None and dmd5 != md5s:
            raise OracleMismatch("GOP batch: a frame's MD5 differs from the "
                                 "committed numpy-oracle MD5s")
        return stats

    if cuda:
        _sync(mesh[0])
        torch.cuda.reset_peak_memory_stats(mesh[0])
    stats = call()
    peak = torch.cuda.max_memory_allocated(mesh[0]) if cuda else None
    fps, ms = [], []
    load0, smi0 = os.getloadavg(), _smi_sample(mesh[0])
    for _ in range(runs):
        s = call()
        fps.append(s["frames"] / s["seconds"])
        ms.append(s["seconds"] * 1e3)
    load1, smi1 = os.getloadavg(), _smi_sample(mesh[0])
    marks = StageMarks(mesh[0])
    split_ms = call(marks)["seconds"] * 1e3
    # the marks come step by step, each step device by device
    steps = gop_step_split(marks, [b[t] for t in range(stats["steps"])
                                   for b in stats["batches"] if t < len(b)])
    return {"device": mesh[0].type, "devices": len(mesh),
            "gops": len(captures), "frames": stats["frames"],
            "steps": stats["steps"], "batches": stats["batches"],
            "fps_runs": fps, **{f"fps_{k}": v for k, v in
                                _spread(fps).items()},
            "ms_runs": ms, "loadavg_before": load0, "loadavg_after": load1,
            "smi_before": smi0, "smi_after": smi1, "step_split": steps,
            "split_ms": split_ms, "peak_bytes": peak,
            "pinned_bytes": stats["host_bytes"] if cuda else 0,
            "equal": True}


def reference_fps(ref_bin: Path, stream: Path) -> float:
    """The reference decoder's best frames/s of -m 1 and -m 8 on `stream`
    (bench.py:70-78)."""
    best = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        for threads in (1, 8):
            r = subprocess.run([str(ref_bin), "-i", str(stream), "-o",
                                os.path.join(tmp, "ref.yuv"), "-m",
                                str(threads)], capture_output=True, text=True,
                               timeout=600)
            fps = [float(line.split("=")[-1].split()[0])
                   for line in r.stdout.splitlines() if "frames/sec" in line]
            if r.returncode != 0 or not fps:
                raise RuntimeError(f"reference decode failed:\n{r.stdout}\n"
                                   f"{r.stderr}")
            best = max(best, fps[-1])
    return best


def report(configs: dict, gop: dict | None, ref: dict | None = None,
           card: str | None = None, gop4k: dict | None = None) -> dict:
    """The last line: bench.py's keys from configs "c2" and "c3" (either
    may be absent: its keys are null; "c4" is only under "configs"), the
    reference's frames/s where
    `ref` holds them ({"c2": fps, "c3": fps}), and everything measured:
    the 1080p GOP batch under "gop", the 4K one under "gop4k" (a key only
    where it ran)."""
    ref = ref or {}
    c2, c3 = configs.get("c2"), configs.get("c3")

    def ratio(c, key):
        return (c["fps_median"] / ref[key]) if c and ref.get(key) else None
    any_config = next(iter(configs.values()), {})
    out = {
        "metric": "decoded_frames_per_sec_1080p_ippp",
        "value": c2["fps_median"] if c2 else None,
        "unit": "frames/s",
        "vs_baseline": ratio(c2, "c2"),
        "ref_fps_best": ref.get("c2"),
        "frames": c2["frames"] if c2 else None,
        "total_ms_per_frame": 1e3 / c2["fps_median"] if c2 else None,
        "host_ms_per_frame": (statistics.median(
            c2["host_ms_per_frame_runs"]) if c2 else None),
        "entropy_ms_per_frame": c2["split"]["entropy_ms"] if c2 else None,
        "pack_ms_per_frame": c2["split"]["pack_ms"] if c2 else None,
        "fps_main_1080p_ra": c3["fps_median"] if c3 else None,
        "ref_fps_main_best": ref.get("c3"),
        "vs_ref_main": ratio(c3, "c3"),
        "frames_main": c3["frames"] if c3 else None,
        "value_runs": c2["fps_runs"] if c2 else None,
        "value_min": c2["fps_min"] if c2 else None,
        "value_max": c2["fps_max"] if c2 else None,
        "fps_main_runs": c3["fps_runs"] if c3 else None,
        "fps_main_min": c3["fps_min"] if c3 else None,
        "fps_main_max": c3["fps_max"] if c3 else None,
        "fps_gop": gop["fps_median"] if gop else None,
        "device": (any_config or gop or {}).get("device"),
        "card": card,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "entropy_engine": any_config.get("entropy_engine"),
        "configs": configs,
        "gop": gop,
    }
    if gop4k is not None:
        out["gop4k"] = gop4k
    return out


def _run_worker(cmd, what):
    """Run one worker process (cwd: the repo) to its end: (what, return
    code, standard output, standard error)."""
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    return what, r.returncode, r.stdout, r.stderr


def _run_workers(jobs) -> dict:
    """Run the worker commands `jobs` [(what, cmd)], at most one a core at a
    time (so the seconds a worker reports are its own, not shared with
    another's), and wait for all of them.  Returns {what: the JSON lines of
    its output}; raises RuntimeError naming every worker that failed."""
    if not jobs:
        return {}
    with concurrent.futures.ThreadPoolExecutor(
            min(len(jobs), os.cpu_count() or 1)) as pool:
        done = list(pool.map(lambda j: _run_worker(j[1], j[0]), jobs))
    failed = [f"{what} (rc {rc}): {err[-2000:]}"
              for what, rc, _, err in done if rc != 0]
    if failed:
        raise RuntimeError("stream workers failed:\n" + "\n".join(failed))
    return {what: [json.loads(x) for x in out.splitlines()
                   if x.startswith("{")] for what, _, out, _ in done}


def _port_digest() -> str:
    """A digest of the port's Python sources: a GOP capture (a pickle of
    the port's pack) is reused only by the same code."""
    h = hashlib.sha1()
    for p in sorted((REPO / "xevd_tpu_torch").rglob("*.py")):
        h.update(p.relative_to(REPO).as_posix().encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def stream_pair(name) -> tuple[Path, Path]:
    """(stream, oracle-MD5 JSON) of config `name`: committed under
    STREAMS_DIR for a COMMITTED config, else cached under FIXTURES."""
    if name in COMMITTED:
        return STREAMS_DIR / f"{name}.evc", STREAMS_DIR / f"{name}.json"
    evc = FIXTURES / f"torch_bench_{name}.evc"
    return evc, evc.with_suffix(".md5.json")


def gop_pair(name) -> tuple[list[Path], Path]:
    """([GOP g's stream], oracle-MD5 JSON) of GOP batch `name`, committed
    under STREAMS_DIR as <name>_<g>.evc and <name>.json."""
    return ([STREAMS_DIR / f"{name}_{g}.evc" for g in range(len(GOPS[name]))],
            STREAMS_DIR / f"{name}.json")


def _where() -> str:
    return (f"tests/torch_reference.py, one process on "
            f"{platform.processor() or platform.machine()} "
            f"({os.cpu_count()} cores); the oracle is xevd_tpu's "
            f"NumpyPixelBackend")


def write_md5s(name, yuv: Path, worker: dict):
    """Write config `name`'s JSON from the oracle's 10-bit YUV and the
    reference worker's record: the spec, each frame's MD5, the seconds of
    the encode and of the oracle's decode, and where they ran (one
    process)."""
    spec = json.loads(json.dumps(CONFIGS[name]))
    rec = {"spec": spec, "md5s": yuv_md5s(yuv.read_bytes(), *spec[:2]),
           "encoder_s": worker["gen_s"], "oracle_s": worker["numpy_s"],
           "where": _where()}
    stream_pair(name)[1].write_text(json.dumps(rec, indent=1) + "\n")


def write_gop_md5s(name, yuvs, workers):
    """Write GOP batch `name`'s JSON from each GOP's oracle YUV and its
    reference worker's record: the spec of every GOP, each GOP's frame
    MD5s, and each GOP's encode and oracle seconds (one process a GOP, at
    most one a core)."""
    spec = json.loads(json.dumps(GOPS[name]))
    rec = {"spec": spec,
           "md5s": [yuv_md5s(y.read_bytes(), *s[:2])
                    for y, s in zip(yuvs, spec)],
           "encoder_s": [w["gen_s"] for w in workers],
           "oracle_s": [w["numpy_s"] for w in workers], "where": _where()}
    gop_pair(name)[1].write_text(json.dumps(rec, indent=1) + "\n")


def committed_gop_md5s(name) -> list[list[str]]:
    """GOP batch `name`'s committed oracle MD5s, a list a GOP; raises unless
    every stream is there and the JSON's spec equals GOPS[name]."""
    evcs, js = gop_pair(name)
    if not (js.exists() and all(e.exists() for e in evcs)
            and json.loads(js.read_text())["spec"]
            == json.loads(json.dumps(GOPS[name]))):
        raise RuntimeError(
            f"{name}: the committed streams {name}_<g>.evc and {js.name} are "
            f"missing or their spec is not GOPS[{name!r}]; make them anew "
            f"with --regenerate")
    return json.loads(js.read_text())["md5s"]


def capture_command(evc: Path, pkl: Path) -> list:
    """The worker that captures GOP stream `evc` into `pkl` (`python -m
    xevd_tpu_torch.parallel.gop --capture`: the serial numpy oracle
    decode with each frame's pack)."""
    return [sys.executable, "-m", "xevd_tpu_torch.parallel.gop", "--capture",
            str(evc), str(pkl)]


def prepare(names, regenerate=False) -> tuple[dict, dict | None, dict]:
    """Generate (or find cached, or committed) the streams of `names`
    ("c2", "c3", "c4", "gop", "gop4k") and their oracle results, every
    worker in parallel (at most one a core), and wait for all of them.  A
    COMMITTED config's or GOP batch's streams are taken as they are when
    the spec equals CONFIGS[name] or GOPS[name], refused otherwise;
    `regenerate` makes those of `names` anew (and captures nothing).  Each
    GOP of a batch is captured from its committed stream by a worker
    (`capture_command`), cached under WORK by the port's digest.  Returns
    ({config: (stream bytes, oracle MD5s)}, {GOP batch: (captures,
    committed MD5s a GOP)} or None without one, {what: the workers'
    gen_s / numpy_s / capture seconds, or "cached" / "committed"})."""
    WORK.mkdir(parents=True, exist_ok=True)
    FIXTURES.mkdir(parents=True, exist_ok=True)
    jobs, info = [], {}
    configs = [n for n in names if n in CONFIGS]
    gop_names = [n for n in names if n in GOPS]
    for name in configs:
        spec = json.loads(json.dumps(CONFIGS[name]))
        evc, md5 = stream_pair(name)
        if regenerate:
            evc.unlink(missing_ok=True)
        elif evc.exists() and md5.exists() and \
                json.loads(md5.read_text())["spec"] == spec:
            info[name] = "committed" if name in COMMITTED else "cached"
            continue
        elif name in COMMITTED:
            raise RuntimeError(
                f"{name}: the committed pair {evc.name}, {md5.name} is "
                f"missing or its spec is not CONFIGS[{name!r}]; make it "
                f"anew with --regenerate")
        jobs.append((name, [sys.executable, str(REFERENCE), json.dumps(spec),
                            str(evc), str(WORK / f"{name}_np.yuv")]))
    digest = _port_digest()
    pkls = {}
    for name in gop_names:
        evcs, _ = gop_pair(name)
        if regenerate:
            for g, evc in enumerate(evcs):
                evc.unlink(missing_ok=True)
                jobs.append((f"{name}{g}", [
                    sys.executable, str(REFERENCE), json.dumps(GOPS[name][g]),
                    str(evc), str(WORK / f"{name}{g}_np.yuv")]))
            continue
        committed_gop_md5s(name)
        info[name] = "committed"
        pkls[name] = [WORK / f"{name}{g}-{digest}.pkl"
                      for g in range(len(evcs))]
        for g, (evc, pkl) in enumerate(zip(evcs, pkls[name])):
            if pkl.exists():
                info[f"{name}{g}"] = "cached"
            else:
                jobs.append((f"{name}{g}", capture_command(evc, pkl)))
    info.update(_run_workers(jobs))     # every worker ends before any clock
    streams = {}
    for name in configs:
        evc, md5 = stream_pair(name)
        if info[name] not in ("cached", "committed"):
            yuv = WORK / f"{name}_np.yuv"
            write_md5s(name, yuv, info[name][-1])
            yuv.unlink()
        streams[name] = (evc.read_bytes(), json.loads(md5.read_text())["md5s"])
    if regenerate:
        for name in gop_names:
            yuvs = [WORK / f"{name}{g}_np.yuv" for g in range(len(GOPS[name]))]
            write_gop_md5s(name, yuvs, [info[f"{name}{g}"][-1]
                                        for g in range(len(yuvs))])
            for y in yuvs:
                y.unlink()
        return streams, None, info
    gops = {}
    for name in gop_names:
        # the pickles are this program's own workers' output
        caps = [pickle.loads(p.read_bytes()) for p in pkls[name]]
        md5s = committed_gop_md5s(name)
        short = [g for g, c in enumerate(caps) if len(c) != len(md5s[g])]
        if short:
            raise RuntimeError(f"{name} captures {short}: not as many frames "
                               "as the committed MD5s")
        gops[name] = (caps, md5s)
    return streams, gops or None, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m xevd_tpu_torch.bench")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the hand-written kernels; cpu: the plain "
                    "PyTorch versions (tests)")
    ap.add_argument("--runs", type=int, default=RUNS,
                    help="timed decodes a config (default %(default)s)")
    ap.add_argument("--only", default="c2,c3,c4,gop,gop4k",
                    help="comma list of c2, c3, c4, gop, gop4k (default all)")
    ap.add_argument("--regenerate", action="store_true",
                    help="make the committed streams and oracle MD5s of "
                    "the configs and GOP batches picked (c4, gop, gop4k) "
                    "anew, rewrite them and exit (c4: over half an hour of "
                    "one core)")
    a = ap.parse_args(argv)
    names = [n for n in a.only.split(",") if n]
    if not names or set(names) - {*CONFIGS, *GOPS} or a.runs < 1:
        ap.error("--only takes c2, c3, c4, gop and gop4k; --runs at least 1")
    if a.regenerate:
        t0 = time.perf_counter()
        _, _, info = prepare([n for n in names if n in COMMITTED], True)
        log(json.dumps(info))
        log(f"regenerated in {time.perf_counter() - t0:.1f} s")
        return 0
    dev = resolve_device(a.device)      # no card: raises before any work
    card = nvidia_smi("name,power.limit") if dev.type == "cuda" else None
    if card:
        log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{dev}, native entropy engine: {host_native.available()}")
    t0 = time.perf_counter()
    streams, gop_caps, info = prepare(names)
    log(f"streams ready in {time.perf_counter() - t0:.1f} s (workers: "
        f"{json.dumps(info)}); every worker has exited")
    load0 = os.getloadavg()
    configs = {name: run_config(*streams[name], dev, a.runs)
               for name in names if name in CONFIGS}
    gops = {name: run_gop(caps, [dev], a.runs, md5s)
            for name, (caps, md5s) in (gop_caps or {}).items()}
    load1 = os.getloadavg()
    ref = {}
    for name, binary in (("c2", "xevdb_app"), ("c3", "xevd_app")):
        ref_bin = REPO / "refbin" / binary
        if name in configs and ref_bin.exists():
            ref[name] = reference_fps(ref_bin, FIXTURES /
                                      f"torch_bench_{name}.evc")
    out = report(configs, gops.get("gop"), ref, card, gops.get("gop4k"))
    out.update(loadavg_before=load0, loadavg_after=load1, workers=info)
    # every decode has been held to the oracle: the numbers may be shown
    for name, c in configs.items():
        s = c["split"]
        log(f"{name}: {c['frames']} frames, frames/s runs "
            f"{[round(f, 3) for f in c['fps_runs']]} (median "
            f"{c['fps_median']:.3f}, spread {c['fps_spread']:.3f}); split "
            f"ms a frame: entropy {s['entropy_ms']:.3f}, derive "
            f"{s['derive_ms']:.3f}, pack {s['pack_ms']:.3f}, slot wait "
            f"{s['slot_wait_ms']:.3f}, upload issue "
            f"{s['upload_host_ms']:.3f} (device "
            f"{s['upload_device_ms']}), D2H {s['d2h_ms']:.3f}, DRA "
            f"{s['dra_ms']:.3f}; busy share "
            f"{(c['traced'] or {}).get('busy_share')}")
    for name, g in gops.items():
        log(f"{name}: {g['frames']} frames of {g['gops']} GOPs in "
            f"{g['steps']} steps, frames/s runs "
            f"{[round(f, 3) for f in g['fps_runs']]} (median "
            f"{g['fps_median']:.3f}, spread {g['fps_spread']:.3f}); peak "
            f"device memory {g['peak_bytes']} B, pinned host buffers "
            f"{g['pinned_bytes']} B")
        for t, st in enumerate(g["step_split"]):
            log(f"  {name} step {t}: {json.dumps(st)}")
    if card:
        log(nvidia_smi("name,power.limit"))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
