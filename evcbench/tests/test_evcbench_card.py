"""A short run of each cell on a card, through the benchmark's command:
marked `cuda`, it skips on a machine without one."""
import json
import subprocess
import sys

import pytest

from evcbench import spec

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark times the card")


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_cell_runs_correct(card, cell):
    r = subprocess.run([sys.executable, "-m", "evcbench.run", "--workload",
                        cell, "--seed", "2147483701", "--seconds", "3",
                        "--trace", "1"], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    for m in spec.cell(cell).per_layer:
        assert m["name"] in out["metrics"]
