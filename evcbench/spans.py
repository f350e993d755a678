"""Per-layer metrics read from the program's own spans and counters
(`xevd_tpu_torch/spans.py`).  Each job is one entry call of
`decode_gops_sharded`; its record holds the entry's spans and the spans of
its GOPs' captures, recorded in the workers and taken in with the
captures.  No entry call follows the window, so the window's last jobs
are the last calls the recorder keeps: all of them, or the last KEEP of a
longer window, which the readers average over (`window`).  A program
without the recorder, or whose records lack a span, gives nothing: the
readers return None.

One clock with the device trace.  Spans are on `time.perf_counter_ns()`
(CLOCK_MONOTONIC: the workers' and the parent's alike); the trace keeps
the benchmark's ranges on its own clock, in microseconds.  A job's
`evcbench.decode` range opens at its first mark, whose host time `Marks`
holds: that pair is the job's offset from the spans' clock to the
trace's, and it places every span of the job, the workers' too.  Each
later mark of the job checks the offset against the start of the
`evcbench.after.<mark>` range it opened (`report`).

`idle(run)` splits the device's idle time in each job, from its first
`capture.gop` start to the end of its `evcbench.call` range, by the
innermost program spans open then (in any process; a stretch under k
innermost spans gives each 1/k of it), and names what lies under none."""
from __future__ import annotations

import bisect
import statistics
from collections import defaultdict

from .trace import AFTER, CALL, CAPTURE, DECODE

NONE = "(no span)"


def recorder():
    """The program's span recorder, or None (a program without one)."""
    try:
        from xevd_tpu_torch import spans
    except ImportError:
        return None
    return spans


def window(run) -> list | None:
    """(index in run.jobs, job, record) of each of the window's last jobs
    that the recorder keeps (all, or the last KEEP), oldest first; None:
    none recorded."""
    SP = recorder()
    if SP is None or not run.jobs:
        return None
    n = min(len(run.jobs), SP.KEEP)
    got = SP.calls(n)
    if len(got) != n:
        return None
    k = len(run.jobs) - n
    return [(k + i, run.jobs[k + i], r) for i, r in enumerate(got)]


def _named(rec, name) -> list:
    return [s for s in rec.spans if s is not None and s.name == name]


def ms_a_job(run, name: str, children: bool = False) -> float | None:
    """The spans named `name` in a job, ms a job over the window's jobs:
    their self time, or with `children` their whole durations."""
    got = window(run)
    if got is None or not all(_named(r, name) for _, _, r in got):
        return None
    SP = recorder()
    each = [SP.total_ms(r.spans, name) if children
            else SP.self_ms(r.spans, name) for _, _, r in got]
    return sum(each) / len(each)


def capture_return_ms(run) -> float | None:
    """From the latest `capture.gop` end of a job to its `entry.plan`
    start, ms a job: the captures pickled, piped and unpickled."""
    got = window(run)
    if got is None:
        return None
    each = []
    for _, _, r in got:
        caps, plan = _named(r, "capture.gop"), _named(r, "entry.plan")
        if not caps or not plan:
            return None
        each.append((plan[0].start_ns - max(s.end_ns for s in caps)) / 1e6)
    return sum(each) / len(each)


def stage_gbps(run) -> float | None:
    """The bytes counted as `stage.bytes` over the host time from each
    step's "start" mark to its "stage" mark, summed over the window's
    last jobs (`window`); GB/s."""
    got = window(run)
    if got is None:
        return None
    SP = recorder()
    nbytes = sum(r.counts.get("stage.bytes", 0) for _, _, r in got)
    ms = sum(j.marks.host_ms("start", "stage") for _, j, _ in got)
    return nbytes / ms / 1e6 if nbytes and ms > 0 else None


def _ranges(trace, name) -> list:
    return sorted((a, b) for n, a, b in trace.ranges if n == name)


def offsets(run) -> list | None:
    """Per job, the offset (us) from the spans' clock (perf_counter) to the
    trace's: its decode range's start less its first mark's time."""
    if run.trace is None:
        return None
    decodes = _ranges(run.trace, DECODE)
    if len(decodes) != len(run.jobs) or not all(j.marks.marks
                                                for j in run.jobs):
        return None
    return [a - j.marks.marks[0][2] * 1e6
            for (a, _), j in zip(decodes, run.jobs)]


def clock_errors_ms(run) -> list:
    """Each job's later marks, placed on the trace by its offset, less the
    start of the `evcbench.after.<mark>` range each opened; ms."""
    offs = offsets(run)
    if offs is None:
        return []
    afters = sorted((a, n) for n, a, _ in run.trace.ranges
                    if n.startswith(AFTER))
    out = []
    for (d0, d1), j, off in zip(_ranges(run.trace, DECODE), run.jobs, offs):
        got = [(a, n) for a, n in afters if d0 <= a <= d1]
        for (name, _, t), (a, n) in zip(j.marks.marks[1:], got[1:]):
            if n == AFTER + name:
                out.append((t * 1e6 + off - a) / 1e3)
    return out


def _merge(iv) -> list:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle(run) -> list | None:
    """Per job of `window`, {"idle_us": the device's idle time in the job,
    "by": {span name or NONE: us of it}}; None without a trace with device
    work or without records."""
    got, offs = window(run), offsets(run)
    if got is None or offs is None or not run.trace.device:
        return None
    calls = _ranges(run.trace, CALL)
    if len(calls) != len(run.jobs):
        return None
    busy = _merge((a, b) for a, b, _, _ in run.trace.device)
    starts = [a for a, _ in busy]
    out = []
    for n, _, rec in got:
        off, (c0, c1) = offs[n], calls[n]
        spans = [(i, s.start_ns / 1e3 + off, s.end_ns / 1e3 + off)
                 for i, s in enumerate(rec.spans) if s is not None]
        gops = [a for i, a, _ in spans if rec.spans[i].name == "capture.gop"]
        t0, t1 = (min(gops) if gops else c0), c1
        cuts = {t0, t1}
        for _, a, b in spans:
            cuts.update(x for x in (a, b) if t0 < x < t1)
        for a, b in busy:
            cuts.update(x for x in (a, b) if t0 < x < t1)
        cuts = sorted(cuts)
        by, total = defaultdict(float), 0.0
        for x, y in zip(cuts, cuts[1:]):
            m = (x + y) / 2
            k = bisect.bisect_right(starts, m) - 1
            if k >= 0 and busy[k][1] > m:
                continue                       # the device is busy
            total += y - x
            on = [i for i, a, b in spans if a <= m < b]
            parents = {rec.spans[i].parent for i in on}
            inner = [i for i in on if i not in parents]
            if not inner:
                by[NONE] += y - x
            for i in inner:
                by[rec.spans[i].name] += (y - x) / len(inner)
        out.append({"idle_us": total, "by": dict(by)})
    return out


def idle_unnamed_ms(run) -> float | None:
    got = idle(run)
    if got is None:
        return None
    return sum(j["by"].get(NONE, 0.0) for j in got) / 1e3 / len(got)


ENTRY = ("entry.plan", "entry.alloc", "entry.steps", "entry.outputs",
         "entry.serial")


def _partition(n, r, j, SP) -> str:
    """Job n's partition: each capture.gop and its children's cover, the
    entry's spans against the call's wall and the harness's host clocks,
    and the self ms of each span name."""
    def ms(*names):
        return sum(SP.total_ms(r.spans, k) for k in names)
    kids = defaultdict(int)
    for s in r.spans:
        if s is not None and s.parent is not None:
            kids[s.parent] += s.end_ns - s.start_ns
    gops = [(s.end_ns - s.start_ns, kids[i]) for i, s in enumerate(r.spans)
            if s is not None and s.name == "capture.gop"]
    wall, entry = j.wall * 1e3, ms(*ENTRY)
    return (f"job {n} spans: capture.gop "
            + ", ".join(f"{d / 1e9:.3f}" for d, _ in gops)
            + " s (children cover "
            + ", ".join(f"{100 * k / d:.3f}" for d, k in gops)
            + f" %); entry spans {entry:.3f} ms of the call's {wall:.3f} "
            f"({100 * entry / wall:.3f} %); plan + alloc "
            f"{ms('entry.plan', 'entry.alloc'):.3f} ms (entry_plan_ms "
            f"{j.plan_s * 1e3:.3f}); outputs + serial "
            f"{ms('entry.outputs', 'entry.serial'):.3f} ms (entry_after_ms "
            f"{(j.wall - j.plan_s - j.seconds) * 1e3:.3f}); self ms "
            f"{SP.self_ms_by_name(r.spans)}")


def _return_trip(run, got) -> list:
    """Per job, the return trip split at the workers' last result in the
    parent (the end of its evcbench.capture range) and at its call."""
    offs = offsets(run)
    if offs is None:
        return []
    caps, calls = _ranges(run.trace, CAPTURE), _ranges(run.trace, CALL)
    if not len(caps) == len(calls) == len(run.jobs):
        return []
    lines = []
    for n, _, r in got:
        off, c1, k0 = offs[n], caps[n][1], calls[n][0]
        gops, plan = _named(r, "capture.gop"), _named(r, "entry.plan")
        if gops and plan:
            end = max(s.end_ns for s in gops) / 1e3 + off
            start = plan[0].start_ns / 1e3 + off
            lines.append(
                f"job {n} return: the last capture.gop's end to the "
                f"workers' last result in the parent {(c1 - end) / 1e3:.3f} "
                f"ms, then to the entry's call {(k0 - c1) / 1e3:.3f} ms, "
                f"then to entry.plan {(start - k0) / 1e3:.3f} ms")
    return lines


def report(run) -> list:
    """Lines for the run's log: each job's partition by its spans, the
    return trip's split, the clock's check and the idle time by innermost
    span."""
    got, SP = window(run), recorder()
    if got is None:
        return []
    lines = [_partition(n, r, j, SP) for n, j, r in got]
    lines += _return_trip(run, got)
    errs = [abs(e) for e in clock_errors_ms(run)]
    if errs:
        lines.append(f"spans' clock: {len(errs)} marks placed by the "
                     f"decode anchor, |mark - its range's start| median "
                     f"{statistics.median(errs):.6f} ms, max "
                     f"{max(errs):.6f} ms")
    got = idle(run)
    if got:
        by = defaultdict(float)
        for j in got:
            for k, v in j["by"].items():
                by[k] += v / 1e3 / len(got)
        lines.append(
            f"device idle by innermost span, ms a job (of "
            f"{sum(j['idle_us'] for j in got) / 1e3 / len(got):.3f}): "
            + ", ".join(f"{k} {v:.3f}" for k, v in
                        sorted(by.items(), key=lambda kv: -kv[1])))
    return lines
