"""Run one cell of the benchmark once:

    python3 -m evcbench.run --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout.  Set-up: the capture workers (`captures.py`,
at most one a core), the kernels (built into the checkout on first use),
and `warmup_jobs` jobs on the configuration's cached captures.  The
window: GOP-batch jobs back to back from one caller until S seconds have
passed, each from stream bytes to pictures: the workers capture the job's
GOPs (the port's host half), then one call of the port's
`xevd_tpu_torch.parallel.gop.decode_gops_sharded` on one card
(`make_mesh` over the cell's chips) decodes them as a batch.  Then every
job's output pictures are compared with the reference decoder's
(`reference.py`), and the last line of standard output is one JSON object:
`correct`, `attempted` and `failed` (pictures), `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics, traced by
`torch.profiler`), `device`, with --trace 1 `breakdown`, and last `checks`,
each number compared beside its limit (also the last lines of standard
error).

Exits 3 without a result when there is no CUDA device or fewer than the
cell's chips, and 4 when the process holds `jax`, `jaxlib`, `flax` or
`xevd_tpu` once the window has closed."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402

from . import captures, reference, spec, traffic, work  # noqa: E402
from .trace import CALL, CAPTURE, WINDOW, Marks, read as read_trace  # noqa: E402

FOREIGN = ("jax", "jaxlib", "flax", "xevd_tpu")
GIB = 1 << 30


@dataclass
class Job:
    order: list            # GOP of each batch slot
    md5s: list             # per slot, the MD5 of each of its pictures
    luma: int              # the job's luma sum, summed on the device
    frames: int
    seconds: float         # the entry's own clock: first upload to last output
    wall: float            # the whole call of the entry
    plan_s: float          # from the call to the first mark: plan, allocation
    marks: Marks
    host_bytes: int
    capture_s: float | None  # the workers' captures (None: from the cache)


@dataclass
class Run:
    """What a per-layer metric's reader reads (evcbench/metrics/*.py)."""
    jobs: list             # the window's jobs
    trace: object          # trace.Trace of the window, or None
    bounds: dict           # {kernel: least seconds}, work.job_bounds summed
    #                        over the window's jobs
    decode_s: float        # the window's jobs' decode seconds


def foreign_modules(names=None) -> list:
    """The top-level names (before the first dot, compared whole) among
    `names` (default: the modules this process holds) that are FOREIGN."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FOREIGN))


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not read"


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             mesh=None, t_start=None, log=None) -> dict:
    """One run of `cell`; returns the result's fields.  `mesh` (default:
    `make_mesh(cell.chips)`) may name CPU devices, which run the plain
    versions (the tests).  The capture workers have all ended when it
    returns."""
    n = min(cell.traffic["gops_per_job"], os.cpu_count() or 1)
    with captures.Workers(n) as workers:
        return _run(cell, seed, seconds, traced, workers, mesh,
                    time.perf_counter() if t_start is None else t_start,
                    log or (lambda *a: print(*a, file=sys.stderr,
                                             flush=True)))


def _run(cell, seed, seconds, traced, workers, mesh, t_start, log) -> dict:
    import torch
    from xevd_tpu_torch.parallel import gop as TG
    mesh = TG.make_mesh(cell.chips) if mesh is None else mesh
    cuda = mesh[0].type == "cuda"
    streams = [p.read_bytes() for p in captures.stream_paths(cell.config)]
    caps, how = captures.load(cell.config, workers)
    ref = reference.load(cell.config)
    log(f"captures: {json.dumps(how)}; {workers.n} capture workers")
    orders = traffic.job_orders(cell.traffic, len(caps), seed)

    def span(name):
        return (torch.profiler.record_function(name) if traced
                else contextlib.nullcontext())

    def job(order, cached=False) -> Job:
        steps = max(len(caps[g]) for g in order) * len(mesh)
        marks = Marks(traced, cuda, steps)
        stats = {}
        capture_s = None
        if cached:
            got = [caps[g] for g in order]
        else:
            with span(CAPTURE):
                t0 = time.perf_counter()
                got = workers.capture([streams[g] for g in order])
                capture_s = time.perf_counter() - t0
                log("captures in the workers: " + ", ".join(
                    f"{x:.3f}" for x in workers.seconds) + " s")
        with span(CALL):
            t0 = time.perf_counter()
            md5s, _ = TG.decode_gops_sharded(
                None, mesh=mesh, captures=got, stats=stats, on_stage=marks)
            wall = time.perf_counter() - t0
        return Job(order, md5s, stats["checksum"], stats["frames"],
                   stats["seconds"], wall, marks.marks[0][2] - t0, marks,
                   stats["host_bytes"], capture_s)

    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.reset_peak_host_memory_stats()
    warm = [job(next(orders), cached=True)
            for _ in range(cell.traffic["warmup_jobs"])]
    t_warm = time.perf_counter()
    workers.ready()
    log(f"set-up: warm-up jobs done at {t_warm - t_start:.3f} s, workers "
        f"ready at {time.perf_counter() - t_start:.3f} s")
    setup_s = time.perf_counter() - t_start
    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    jobs = []
    with span(WINDOW):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            jobs.append(job(next(orders)))
        window_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    host = torch.cuda.host_memory_stats() if cuda else {}
    trace = None
    if prof is not None:
        prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            trace = read_trace(path)
        finally:
            os.unlink(path)
    for i, j in enumerate(warm + jobs):
        cap = ("cached" if j.capture_s is None
               else f"{j.capture_s * 1e3:.3f} ms")
        log(f"job {i - len(warm)}: {j.frames} pictures, captures {cap}, "
            f"decode {j.seconds * 1e3:.3f} ms (entry's clock; staging "
            f"{j.marks.host_ms('start', 'stage'):.3f}), plan and allocation "
            f"{j.plan_s * 1e3:.3f} ms, whole call {j.wall * 1e3:.3f} ms")
    decode_s = sum(j.seconds for j in jobs)
    frames = sum(j.frames for j in jobs)
    log(f"window: {len(jobs)} jobs, {frames} pictures in {window_s:.6f} s; "
        f"captures {sum(j.capture_s for j in jobs):.6f} s, entry calls "
        f"{sum(j.wall for j in jobs):.6f} s, decode {decode_s:.6f} s")
    numbers = reference.compare(
        [(j.order, j.md5s, j.luma) for j in warm + jobs], ref)
    checks = {k: {"value": numbers[k], "limit": v}
              for k, v in reference.LIMITS.items()}
    correct = bool(jobs) and all(c["value"] <= c["limit"]
                                 for c in checks.values())
    device = {"platform": "gpu" if cuda else mesh[0].type,
              "kind": torch.cuda.get_device_name(mesh[0]) if cuda else "cpu",
              "count": len(mesh), "memory_peak_bytes": memory_peak}
    e2e = {"job_fps": frames / window_s if jobs else None,
           "device_peak_gib": memory_peak / GIB,
           "host_pinned_gib": host.get("allocated_bytes.peak", 0) / GIB,
           "setup_s": setup_s}
    log(f"host pinned: allocator peak {host.get('allocated_bytes.peak')} B "
        f"(active peak {host.get('active_bytes.peak')} B); the entry's "
        f"host_bytes {jobs[-1].host_bytes if jobs else None} B")
    out = {"correct": correct, "attempted": numbers["pictures"],
           "failed": numbers["pictures_differing"], "device": device}
    if traced:
        run = Run(jobs, trace, job_bounds(caps, jobs), decode_s)
        out["metrics"] = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(run)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        if trace is not None:
            a, b = trace.window()
            device.update(busy_s=trace.busy_us() / 1e6, window_s=window_s)
            out["breakdown"] = {"device_ops": trace.device_ops(),
                                "idle_gaps": trace.idle_gaps(a, b)}
    else:
        out["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end
                          if e2e.get(m["name"]) is not None}
    out["checks"] = checks
    return out


def job_bounds(caps, jobs) -> dict:
    """`work.job_bounds` summed over `jobs` (once for each set of GOPs)."""
    each, total = {}, {}
    for j in jobs:
        key = tuple(sorted(j.order))
        if key not in each:
            each[key] = work.job_bounds([caps[g] for g in key])
        for k, v in each[key].items():
            total[k] = total.get(k, 0.0) + v
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m evcbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = spec.cell(a.workload)
    # the program's Triton cache inside the checkout, at a fixed path
    os.environ["TRITON_CACHE_DIR"] = str(spec.ROOT / "build" / "evcbench"
                                         / "triton")
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"evcbench: the cell needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    out = run_cell(cell, a.seed, a.seconds, bool(a.trace), t_start=T_START)
    found = foreign_modules()
    if found:
        print(f"evcbench: the process holds {', '.join(found)} after the "
              "window; no result", file=sys.stderr)
        return 4
    print(card_line(), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
