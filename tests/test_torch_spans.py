"""The port's span recorder (xevd_tpu_torch/spans.py) on the CPU: nesting,
self time, per-thread parents, counters and the bound of KEEP entry calls;
the spans of a GOP's capture (`parallel/gop.py` `_capture_gop`) and of the
GOP entry (`decode_gops_sharded`), which takes its captures' spans in
under its call number; and the benchmark's readers of them
(evcbench/spans.py, evcbench/metrics/) on a synthetic run and trace whose
clocks differ by a known offset."""
import pickle
import sys
import threading
import time
from pathlib import Path

import pytest

from evcbench import run as R
from evcbench import spans as ES
from evcbench import spec
from evcbench import trace as T
from xevd_tpu_torch import spans as SP
from xevd_tpu_torch.host import native
from xevd_tpu_torch.parallel import gop as TG

REPO = Path(__file__).resolve().parent.parent
CAPTURE_SPANS = {"capture.gop", "host.parse", "host.entropy", "host.derive",
                 "capture.pack", "capture.numpy", "capture.numpy.deblock"}
ENTRY_SPANS = ("entry.plan", "entry.alloc", "entry.steps", "entry.outputs",
               "entry.serial")
METRICS = ("capture_parse_ms", "capture_entropy_ms", "capture_derive_ms",
           "capture_pack_ms", "capture_numpy_ms", "capture_return_ms",
           "entry_alloc_ms", "entry_outputs_ms", "entry_serial_ms",
           "stage_gbps", "idle_unnamed_ms", "capture_oracle_pct")


def S(name, a, b, parent=None):
    """A span from a to b seconds."""
    return SP.Span(name, int(a * 1e9), int(b * 1e9), parent)


@pytest.fixture(scope="module")
def gops():
    """Two 64x64 IPPP GOPs of 3 pictures, as tests/test_torch_gop.py makes
    them (xevd_tpu.parallel.gop.gen_gop_streams's encoder call)."""
    sys.path.insert(0, str(REPO / "tools"))
    import evc_enc
    return [evc_enc.encode_stream(64, 64, 3, 30, 1000 + 7 * g, "IPPP", 0.5)
            for g in range(2)]


def test_spans_nest_and_self_time_is_what_children_leave():
    with SP.record() as rec:
        with SP.span("a"):
            with SP.span("b"):
                time.sleep(0.002)
            SP.run("c", time.sleep, 0.002)
        with SP.span("d"):
            pass
    names = [s.name for s in rec.spans]
    assert names == ["a", "b", "c", "d"]
    a, b, c, d = rec.spans
    assert (a.parent, b.parent, c.parent, d.parent) == (None, 0, 0, None)
    assert a.start_ns <= b.start_ns < b.end_ns <= c.start_ns < c.end_ns \
        <= a.end_ns <= d.start_ns <= d.end_ns
    own = (a.end_ns - a.start_ns) - (b.end_ns - b.start_ns) \
        - (c.end_ns - c.start_ns)
    assert SP.self_ns(rec.spans, "a") == own
    assert SP.self_ms(rec.spans, "b") == (b.end_ns - b.start_ns) / 1e6
    assert SP.total_ms(rec.spans, "a") == (a.end_ns - a.start_ns) / 1e6


def test_self_time_counts_overlapping_children_once():
    spans = [S("p", 0, 10), S("k", 1, 4, 0), S("k", 3, 6, 0), None,
             S("k", 9, 12, 0), S("q", 20, 21)]
    assert SP.self_ns(spans, "p") == 10e9 - 5e9 - 1e9       # 1-6 and 9-10
    assert SP.self_ns(spans, "k") == 9e9
    assert SP.self_ms_by_name(spans) == {"p": 4000.0, "k": 9000.0,
                                         "q": 1000.0}


def test_a_decorated_function_and_a_pool_thread():
    @SP.span("f")
    def f(x):
        SP.add("f.calls")
        return x + 1

    got = []
    with SP.record() as rec:
        with SP.span("outer"):
            t = threading.Thread(target=lambda: got.append(
                SP.run("thread", f, 1)))
            t.start()
            t.join()
            with SP.span("child"):
                SP.add("n", 2)
                SP.add("n", 3)
            assert f(2) == 3
        SP.add("n", 5)
    by = {s.name: (i, s) for i, s in enumerate(rec.spans)}
    assert got == [2]
    # the thread's spans have no parent on their thread: not "outer"
    assert by["thread"][1].parent is None
    assert [s.parent for s in rec.spans if s.name == "f"] == [
        by["thread"][0], by["outer"][0]]
    assert by["child"][1].parent == by["outer"][0]
    # counters add to the open record, from any thread and in any span
    assert rec.counts == {"f.calls": 2, "n": 10}


def test_nothing_is_kept_without_a_record():
    with SP.span("loose"):
        SP.add("loose")
    with SP.record() as rec:
        pass
    assert rec.spans == [] and rec.counts == {}


def test_entry_calls_are_numbered_and_the_last_keep_kept():
    nums = []
    for _ in range(SP.KEEP + 4):
        with SP.entry() as r:
            with SP.span("x"):
                pass
        nums.append(r.call)
    assert nums == list(range(nums[0], nums[0] + SP.KEEP + 4))
    assert [r.call for r in SP.calls(100)] == nums[-SP.KEEP:]
    assert [r.call for r in SP.calls(3)] == nums[-3:]
    assert SP.calls(0) == []
    assert [[s.name for s in r.spans] for r in SP.calls(3)] == [["x"]] * 3


def test_take_reindexes_a_record_from_elsewhere():
    made = SP.Record(None, [S("g", 0, 4), S("h", 1, 2, 0)],
                     {"k": 7, "j": 1})
    made = pickle.loads(pickle.dumps(made))          # as from a worker
    with SP.entry() as rec:
        with SP.span("first"):
            SP.add("k", 3)
        SP.take(made)
    SP.take(made)                                    # no record open
    assert [(s.name, s.parent) for s in rec.spans] == [
        ("first", None), ("g", None), ("h", 1)]
    assert rec.spans[1:] == [S("g", 0, 4), S("h", 1, 2, 1)]
    assert rec.counts == {"k": 10, "j": 1}
    assert SP.calls(1) == [rec]


def test_the_recorders_cost_is_measured():
    from tests.torch_span_cost import cost
    c = cost(2000)
    assert c["loop_ns_with"] > c["loop_ns_without"] > 0


def test_capture_spans_nest_and_cover_the_capture(gops):
    native.get_lib()                  # as each capture worker does first
    cap = TG._capture_gop(gops[0], oracle=True)
    again = pickle.loads(pickle.dumps(cap))
    assert len(again) == len(cap) == 3
    assert ["spans" in fr for fr in again] == [True, False, False]
    made = again[0]["spans"]
    spans = made.spans
    assert {s.name for s in spans} == CAPTURE_SPANS
    assert spans[0].name == "capture.gop" and spans[0].parent is None
    by = {i: s for i, s in enumerate(spans)}
    for s in spans[1:]:
        p = by[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        assert {"host.parse": "capture.gop", "host.entropy": "host.parse",
                "host.derive": "host.parse", "capture.pack": "host.parse",
                "capture.numpy": "host.parse",
                "capture.numpy.deblock": "capture.numpy"}[s.name] == p.name
    # the spans under capture.gop leave under 1 % of it
    whole = spans[0].end_ns - spans[0].start_ns
    assert SP.self_ns(spans, "capture.gop") < 0.01 * whole
    assert sum(s.name == "capture.numpy" for s in spans) == 3
    assert made.counts == {"capture.pictures": 3,
                           "capture.oracle_pictures": 3}


def test_entry_takes_the_captures_spans_and_covers_its_call(gops):
    caps = [TG._capture_gop(g, oracle=True) for g in gops]
    stats = {}
    t0 = time.perf_counter_ns()
    dev, ser = TG.decode_gops_sharded(None, mesh=TG.make_mesh(["cpu"]),
                                      captures=caps, stats=stats)
    wall = time.perf_counter_ns() - t0
    assert dev == ser
    (rec,) = SP.calls(1)
    taken = [s for s in rec.spans if s.name in CAPTURE_SPANS]
    assert [(s.name, s.start_ns, s.end_ns) for s in taken] == [
        (s.name, s.start_ns, s.end_ns) for c in caps
        for s in c[0]["spans"].spans]
    for s in taken:
        if s.parent is not None:
            assert rec.spans[s.parent].name in CAPTURE_SPANS
    assert rec.counts["stage.bytes"] > 0
    entry = [s for s in rec.spans if s.name in ENTRY_SPANS]
    assert [s.name for s in entry] == list(ENTRY_SPANS)
    assert all(a.end_ns <= b.start_ns for a, b in zip(entry, entry[1:]))
    assert t0 <= entry[0].start_ns and entry[-1].end_ns <= t0 + wall
    assert sum(s.end_ns - s.start_ns for s in entry) >= 0.99 * wall
    steps = next(s for s in entry if s.name == "entry.steps")
    assert stats["seconds"] * 1e9 <= steps.end_ns - steps.start_ns


def test_entry_with_streams_records_its_captures(gops):
    TG.decode_gops_sharded(gops, mesh=TG.make_mesh(["cpu"]))
    (rec,) = SP.calls(1)
    assert sum(s.name == "capture.gop" for s in rec.spans) == 2
    assert sum(s.name == "entry.plan" for s in rec.spans) == 1


# -- the benchmark's readers, on a synthetic job ---------------------------

OFF = 5_000_000.0               # trace us = span ns / 1e3 + OFF
MARKS = [("start", 10.0), ("stage", 10.001), ("copy", 10.0012),
         ("wait", 10.0013), ("step", 10.002), ("output", 10.003)]


def us(seconds):
    return seconds * 1e6 + OFF


def synthetic_run(n=1):
    """n jobs, each 20 s after the one before, each of them: two GOPs'
    capture spans (1-9 s and 1.5-8.5 s), the entry's spans 9.5-10.2 s with
    its marks at 10.000-10.003 s, 2 MB staged, 6 pictures captured, each
    also by the numpy oracle; the trace on a clock OFF us ahead, the card
    busy 10.0005-10.0015 s."""
    jobs, ranges, device = [], [(T.WINDOW, us(0.5), us(20 * n - 9.7))], []
    for q in range(n):
        d = 20.0 * q
        spans = [S("capture.gop", 1.0 + d, 9.0 + d),
                 S("host.parse", 1.0 + d, 9.0 + d, 0),
                 S("host.entropy", 1.0 + d, 2.0 + d, 1),
                 S("host.derive", 2.0 + d, 2.5 + d, 1),
                 S("capture.pack", 2.5 + d, 3.0 + d, 1),
                 S("capture.numpy", 3.0 + d, 8.0 + d, 1),
                 S("capture.numpy.deblock", 4.0 + d, 7.0 + d, 5),
                 S("capture.gop", 1.5 + d, 8.5 + d),
                 S("host.parse", 1.5 + d, 8.5 + d, 7),
                 S("host.entropy", 1.5 + d, 2.5 + d, 8),
                 S("entry.plan", 9.5 + d, 9.6 + d),
                 S("entry.alloc", 9.6 + d, 9.8 + d),
                 S("entry.steps", 9.8 + d, 10.004 + d),
                 S("entry.outputs", 10.004 + d, 10.1 + d),
                 S("entry.serial", 10.1 + d, 10.2 + d)]
        with SP.entry() as rec:
            rec.spans.extend(spans)
            SP.add("stage.bytes", 2_000_000)
            SP.add("capture.pictures", 6)
            SP.add("capture.oracle_pictures", 6)
        marks = [(name, t + d) for name, t in MARKS]
        m = T.Marks(traced=False, cuda=False, steps=1)
        m.marks = [(name, None, t) for name, t in marks]
        jobs.append(R.Job(order=[0, 1], md5s=[], luma=0, frames=6,
                          seconds=0.003, wall=0.7, plan_s=0.5, marks=m,
                          host_bytes=0, capture_s=8.0))
        ranges += [(T.CAPTURE, us(0.9 + d), us(9.4 + d)),
                   (T.CALL, us(9.5 + d), us(10.2 + d)),
                   (T.DECODE, us(10.0 + d), us(10.003 + d))]
        # each mark opens its range 10 us after the mark
        ranges += [(T.AFTER + name, us(t) + (10.0 if i else 0.0),
                    us(marks[i + 1][1]))
                   for i, (name, t) in enumerate(marks[:-1])]
        device.append((us(10.0005 + d), us(10.0015 + d), "k", True))
    tr = T.Trace(device=device, ranges=ranges)
    return R.Run(jobs=jobs, trace=tr, bounds={}, decode_s=0.003 * n)


WANT = (7000.0, 2000.0, 500.0, 500.0, 5000.0, 500.0, 200.0, 96.0, 100.0,
        2.0, 500.0, 100.0)


@pytest.mark.parametrize("name,want", zip(METRICS, WANT))
def test_span_metric_reads_the_synthetic_job(name, want):
    r = synthetic_run()
    assert spec.metric_reader(name)(r) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name,want", zip(METRICS, WANT))
def test_span_metric_reads_the_last_keep_jobs_of_a_longer_window(name,
                                                                 want):
    """KEEP + 1 jobs: the readers take the last KEEP, each paired with its
    own job, marks and ranges."""
    r = synthetic_run(SP.KEEP + 1)
    assert spec.metric_reader(name)(r) == pytest.approx(want, rel=1e-6)


def test_span_metrics_share_one_clock_with_the_trace():
    r = synthetic_run()
    assert ES.offsets(r) == [pytest.approx(OFF - 0.0)]
    # each later mark lands 10 us before the range it opened
    assert ES.clock_errors_ms(r) == pytest.approx([-0.01] * 4)
    (job,) = ES.idle(r)
    assert job["idle_us"] == pytest.approx(9.2e6 - 1e3)
    assert sum(job["by"].values()) == pytest.approx(job["idle_us"])
    assert job["by"][ES.NONE] == pytest.approx(0.5e6)     # 9.0-9.5 s
    # 1.0-1.5 s under GOP 0's entropy alone, 1.5-2.0 s under both GOPs'
    # entropy, 2.0-2.5 s half GOP 0's derive, half GOP 1's entropy
    assert job["by"]["host.entropy"] == pytest.approx(1.25e6)
    assert job["by"]["host.derive"] == pytest.approx(0.25e6)
    assert job["by"]["entry.steps"] == pytest.approx(0.204e6 - 1e3)
    lines = ES.report(r)
    assert any("median 0.010000 ms" in x for x in lines)


def test_span_metrics_read_nothing_without_the_recorder(monkeypatch):
    r = synthetic_run()
    monkeypatch.setattr(ES, "recorder", lambda: None)
    for name in METRICS:
        assert spec.metric_reader(name)(r) is None, name


def test_span_metrics_are_appended_to_benchmark_json():
    per_layer = spec.benchmark()["per_layer"]
    assert tuple(m["name"] for m in per_layer[-len(METRICS):]) == METRICS
    assert all(m["source"] == "program_span" and m["moves"] == "job_fps"
               and "workloads" not in m for m in per_layer[-len(METRICS):])
