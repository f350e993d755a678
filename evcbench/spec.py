"""The benchmark's data, found by name: `BENCHMARK.json` at the checkout's
root, and under evcbench/ a file for each configuration
(`configs/<name>.json`), traffic mix (`traffic/<name>.json`) and per-layer
metric (`metrics/<name>.py`).  Nothing here names a cell, a configuration
or a metric: a later one is added as files and entries."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

from . import traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    """One entry of `workloads`, with its configuration's and traffic's
    data and the metrics it reports."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`'s BENCHMARK.json; raises KeyError for a
    name that is not there."""
    b = benchmark(root)
    by_name = {w["name"]: w for w in b["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (there are "
                       f"{', '.join(by_name)})")
    w = by_name[name]
    conf = next(c for c in b["configs"] if c["name"] == w["config"])
    return Cell(name=name, chips=w["chips"],
                config=load_json(root / conf["file"]),
                traffic=traffic.check(load_json(
                    HERE / "traffic" / f"{w['traffic']}.json"), w["traffic"]),
                end_to_end=[m for m in b["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in b["per_layer"] if _reports(m, name)])


def metric_reader(name: str):
    """The `read` function of evcbench/metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"evcbench.metrics.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
