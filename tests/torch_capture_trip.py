"""The return trip of the GOP captures, split on one clock: each capture
made in a worker of the benchmark's own pool (`evcbench/captures.py`
`Workers`: spawned, one thread each), pickled there, sent through the
pool's one result pipe and unpickled in the parent by the pool's result
thread, then handed to the caller.

    python tests/torch_capture_trip.py [--jobs N] [--out FILE] [STREAM ...]

STREAM defaults to the benchmark's GOP streams (evcbench/streams/
gop1080_*.evc), one worker each (at most one a core), as a job of
`gop1080-base-short` hands them over.  Jobs alternate between no profiler
and torch.profiler on in the parent (CPU and, with a card, CUDA
activities), as the benchmark's untraced and traced runs.

Each capture travels as (marker, capture, marker): a marker stamps
`time.perf_counter_ns()` (CLOCK_MONOTONIC, one clock for every process of
the host) when the worker's pickler reaches it and when the parent's
unpickler rebuilds it, so each GOP gives its capture's end, its pickling
in the worker, the wait from the end of its pickling to the start of its
unpickling (the pipe, the pool's write lock and the result thread's
queue), its unpickling, and the caller's receipt.  The result thread
takes one result at a time, so a result's pipe time is the part of that
wait after the result thread finished the result before it.

Probes of as many bytes (--probe-bytes without jobs): a bytes object
returned through the same pool between markers, before the jobs (fresh
workers) and after them; and one `multiprocessing` Connection from a
spawned process alone, read by the parent's main thread and by a thread
of its own (also in fixed 1 MiB reads instead of `recv_bytes`), with
nothing else running.  And the capacity of each pipe (F_GETPIPE_SZ: the
pool's result pipe, a new one) with the host's per-user soft limit on
pipe pages, read only.

Prints one line a job and one JSON object last (also to --out).  Needs
no card; imports no JAX."""
import argparse
import fcntl
import json
import multiprocessing
import os
import pickle
import struct
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _landed(sent_ns):
    """A marker rebuilt by the unpickler: (its pickling's time, now)."""
    return sent_ns, time.perf_counter_ns()


class Marker:
    def __reduce__(self):
        return _landed, (time.perf_counter_ns(),)


def stamped_capture(data: bytes) -> tuple:
    """The worker's side: the port's capture of one GOP between markers,
    with the capture's end."""
    from xevd_tpu_torch.parallel.gop import _capture_gop
    cap = _capture_gop(data)
    return Marker(), cap, Marker(), time.perf_counter_ns()


def blob(n: int) -> tuple:
    """The worker's side of the pool probe: n bytes between markers."""
    return Marker(), b"\0" * n, Marker()


def pool_probe(workers, nbytes: int, times: int = 3) -> list:
    """ms from the end of a worker's pickling of `nbytes` bytes to the
    start of the parent's unpickling, through the pool, one at a time."""
    out = []
    for _ in range(times):
        (_, u0), _, (p1, _) = workers.pool.apply_async(blob,
                                                        (nbytes,)).get()
        out.append((u0 - p1) / 1e6)
    return out


def _send(conn, n):
    data = b"\0" * n
    conn.send(time.perf_counter_ns())
    conn.send_bytes(data)


def _recv_fixed(conn, chunk=1 << 20) -> bytearray:
    """Connection.recv_bytes's message, read in fixed `chunk` reads into
    one buffer."""
    fd = conn.fileno()
    (size,) = struct.unpack("!i", os.read(fd, 4))
    buf = bytearray(size)
    view, got = memoryview(buf), 0
    while got < size:
        got += os.readv(fd, [view[got:got + chunk]])
    return buf


def pipe_size(fd: int) -> int | None:
    try:
        return fcntl.fcntl(fd, getattr(fcntl, "F_GETPIPE_SZ", 1032))
    except OSError:
        return None


def pipe_probe(nbytes: int, times: int = 3, thread: bool = False,
               fixed: bool = False) -> list:
    """ms to move `nbytes` through one Connection from a spawned process,
    from the sender's stamp to the end of the parent's recv_bytes (on a
    thread of its own with `thread`; in fixed reads with `fixed`)."""
    import threading
    ctx = multiprocessing.get_context("spawn")
    out = []
    for _ in range(times):
        a, b = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_send, args=(b, nbytes))
        p.start()

        def recv():
            t0 = a.recv()
            _recv_fixed(a) if fixed else a.recv_bytes()
            out.append((time.perf_counter_ns() - t0) / 1e6)
        if thread:
            t = threading.Thread(target=recv)
            t.start()
            t.join()
        else:
            recv()
        p.join()
    return out


def one_job(workers, streams, profile) -> dict:
    """One job's captures through the pool, each GOP's stamps in ms from
    the job's start."""
    import contextlib
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    ctx = (torch.profiler.profile(activities=acts) if profile
           else contextlib.nullcontext())
    with ctx:
        t0 = time.perf_counter_ns()
        pending = [workers.pool.apply_async(stamped_capture, (s,))
                   for s in streams]
        got = []
        for p in pending:
            (p0, u0), cap, (p1, u1), end = p.get()
            got.append((end, p0, p1, u0, u1, time.perf_counter_ns(), cap))

    def ms(t):
        return round((t - t0) / 1e6, 3)
    gops = [{"capture_end": ms(end), "pickle_start": ms(p0),
             "pickle_end": ms(p1), "unpickle_start": ms(u0),
             "unpickle_end": ms(u1), "received": ms(r),
             "bytes": len(pickle.dumps(cap, 4))}
            for end, p0, p1, u0, u1, r, cap in got]
    # the result thread takes one result at a time, in the order they land
    prev = None
    for g in sorted(gops, key=lambda g: g["unpickle_start"]):
        ready = g["pickle_end"] if prev is None else max(g["pickle_end"],
                                                         prev)
        g.update(pickle_ms=round(g["pickle_end"] - g["pickle_start"], 3),
                 wait_ms=round(g["unpickle_start"] - g["pickle_end"], 3),
                 pipe_ms=round(g["unpickle_start"] - ready, 3),
                 unpickle_ms=round(g["unpickle_end"] - g["unpickle_start"],
                                   3))
        prev = g["unpickle_end"]
    last = max(g["capture_end"] for g in gops)

    def total(k):
        return round(sum(g[k] for g in gops), 3)
    return {"profiled": profile, "gops": gops,
            "trip_ms": round(max(g["received"] for g in gops) - last, 3),
            "last_unpickled_ms": round(
                max(g["unpickle_end"] for g in gops) - last, 3),
            "pickle_ms": total("pickle_ms"), "pipe_ms": total("pipe_ms"),
            "unpickle_ms": total("unpickle_ms"),
            "MB_a_s_in_pipe": round(total("bytes") / 1e3
                                    / max(total("pipe_ms"), 1e-3), 1)}


def main(argv=None) -> int:
    from evcbench import captures, spec
    ap = argparse.ArgumentParser()
    ap.add_argument("streams", nargs="*", type=Path)
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--probe-bytes", type=int, default=66_500_000)
    a = ap.parse_args(argv)
    paths = a.streams or captures.stream_paths(
        spec.cell("gop1080-base-short").config)
    streams = [p.read_bytes() for p in paths]
    import torch
    from xevd_tpu_torch.parallel import gop  # noqa: F401  (as a run's parent)
    if torch.cuda.is_available():
        torch.cuda.init()              # the parent holds a card, as a run's
    n = min(len(streams), os.cpu_count() or 1)
    jobs, probes = [], {}
    size = a.probe_bytes
    with captures.Workers(n) as workers:
        workers.ready()
        pipes = {"pool_result": pipe_size(
            workers.pool._outqueue._reader.fileno())}
        probes["pool_fresh_ms"] = pool_probe(workers, size)
        for i in range(a.jobs):
            j = one_job(workers, streams, profile=bool(i % 2))
            jobs.append(j)
            how = "profiler on" if j["profiled"] else "no profiler"
            print(f"job {i} ({how}): last capture's end to the caller's "
                  f"receipt {j['trip_ms']:.3f} ms; summed over "
                  f"{len(streams)} GOPs: "
                  f"pickle {j['pickle_ms']:.3f}, pipe {j['pipe_ms']:.3f}, "
                  f"unpickle {j['unpickle_ms']:.3f} ms; "
                  f"{j['MB_a_s_in_pipe']} MB/s in the pipe", flush=True)
        if jobs:
            probes["pool_after_ms"] = pool_probe(workers, size)
    probes["alone_ms"] = pipe_probe(size)
    probes["alone_thread_ms"] = pipe_probe(size, thread=True)
    probes["alone_thread_fixed_ms"] = pipe_probe(size, thread=True,
                                                 fixed=True)
    a_, b_ = multiprocessing.Pipe(duplex=False)
    pipes["new"] = pipe_size(a_.fileno())
    try:
        pipes["user_pages_soft"] = int(Path(
            "/proc/sys/fs/pipe-user-pages-soft").read_text())
    except (OSError, ValueError):
        pipes["user_pages_soft"] = None
    print(f"pipe capacity: {pipes}", flush=True)
    for k, v in probes.items():
        print(f"{size} B, {k}: " + ", ".join(f"{x:.3f}" for x in v),
              flush=True)
    out = {"workers": n, "cpus": os.cpu_count(), "jobs": jobs,
           "probe_bytes": size, "probes": probes, "pipes": pipes}
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    # the pool pickles these functions by their module's name: import it
    # under its own so that the spawned workers find them
    from tests import torch_capture_trip as M
    sys.exit(M.main())
