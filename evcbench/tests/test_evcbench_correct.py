"""`correct` on the CPU at a size a test run holds: the test streams
(evcbench/tests/data, 64x64 GOPs, 8-bit Baseline and 10-bit Main) through
the harness's run with its look for a chip skipped (the port's plain
versions on the CPU), the control, and the faults a GOP-batch decode can
have, planted under the timed path: each must make `correct` false."""
import multiprocessing

import numpy as np
import pytest
import torch

from evcbench import reference as R
from evcbench import run, spec, traffic
from evcbench.captures import stream_paths

DATA = spec.HERE / "tests" / "data"
B = spec.benchmark()


def tiny_cell(name: str) -> spec.Cell:
    conf = spec.load_json(DATA / f"{name}.config.json")
    return spec.Cell(name=name, chips=1, config=conf,
                     traffic={"gops_per_job": len(conf["gops"]),
                              "warmup_jobs": 1},
                     end_to_end=B["end_to_end"], per_layer=B["per_layer"])


def cpu_run(name, seed=2**31 + 11, traced=False):
    return run.run_cell(tiny_cell(name), seed, 0.2, traced,
                        mesh=[torch.device("cpu")], log=lambda *a: None)


@pytest.mark.parametrize("name", ["tiny8", "tiny10"])
def test_sound_run_is_correct(name):
    out = cpu_run(name)
    assert not multiprocessing.active_children()   # the workers have ended
    assert out["correct"] and out["failed"] == 0
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0


@pytest.mark.parametrize("name", ["tiny8", "tiny10"])
def test_control_fails(name):
    """The reference's own pictures at the next precision below the
    stream's, in the program's place, over jobs of three seeds."""
    conf = spec.load_json(DATA / f"{name}.config.json")
    pics = [R.decode(p.read_bytes()) for p in stream_paths(conf)]
    ref = R.load(conf)
    assert [[R.picture_md5(p, bd) for p, bd in g] for g in pics] == \
        ref["md5s"]
    low = [[R.lower_precision(p, conf["bit_depth"]) for p, _ in g]
           for g in pics]
    whole = {"gops_per_job": len(pics)}
    for seed in (1, 2**31 + 5, 2**40):
        order = next(traffic.job_orders(whole, len(pics), seed))
        job = (order,
               [[R.picture_md5(p, conf["bit_depth"]) for p in low[g]]
                for g in order],
               sum(R.luma_sum(p) for g in order for p in low[g]))
        got = R.compare([job], ref)
        assert got["pictures_differing"] > R.LIMITS["pictures_differing"]
        assert got["jobs_luma_sum_differing"] > 0


def _unchanged(batch, tables, dpb, on_stage=None):
    return dpb.out                      # the step leaves its state as it was


def _half_left_out(real):
    def step(batch, tables, dpb, on_stage=None):
        out = real(batch, tables, dpb, on_stage)
        for o in out:
            o[o.shape[0] // 2:] = 0      # the batch's second half not decoded
        return out
    return step


def _altered(real):
    def step(batch, tables, dpb, on_stage=None):
        out = real(batch, tables, dpb, on_stage)
        out[0][0, 150, 150] += 1         # one sample of one picture
        return out
    return step


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out", "altered"])
def test_planted_fault_is_not_correct(monkeypatch, fault):
    from xevd_tpu_torch.parallel import gop as TG
    real = TG.run_frames_device
    fake = {"unchanged": _unchanged, "half_left_out": _half_left_out(real),
            "altered": _altered(real)}[fault]
    monkeypatch.setattr(TG, "run_frames_device", fake)
    out = cpu_run("tiny8")
    assert not out["correct"] and out["failed"] > 0


def test_compare_counts_missing_pictures():
    ref = {"md5s": [["a", "b"], ["c"]], "luma_sums": [[1, 2], [3]]}
    assert R.compare([([1, 0], [["c"], ["a", "b"]], 6)], ref) == {
        "pictures": 3, "pictures_differing": 0, "jobs_luma_sum_differing": 0}
    got = R.compare([([1, 0], [["c"], ["a"]], 5)], ref)
    assert got["pictures_differing"] == 1
    assert got["jobs_luma_sum_differing"] == 1
    got = R.compare([([1, 0], [["c"]], 6)], ref)
    assert got["pictures_differing"] == 2


def test_lower_precision_rounds_to_the_lower_depth():
    p = np.array([[0, 1, 2, 1021, 1022, 1023]], np.int32)
    y, = R.lower_precision((p,), 10)[:1]
    assert y.tolist() == [[0, 0, 4, 1020, 1023, 1023]]
    q = np.array([[0, 1, 254, 255]], np.int32)
    assert R.lower_precision((q,), 8)[0].tolist() == [[0, 2, 254, 255]]
