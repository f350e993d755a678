"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix and metric is found by its name and is well formed."""
import json
import re

import pytest

from evcbench import captures, reference, spec

B = spec.benchmark()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
ONE_LINE = re.compile(r"[^\t\n\r]{1,200}")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def valid_name(s) -> bool:
    return isinstance(s, str) and NAME.fullmatch(s) is not None


def valid_unit(s) -> bool:
    return isinstance(s, str) and UNIT.fullmatch(s) is not None


def test_top_level_keys_and_command():
    assert set(B) == TOP
    assert B["paths"] == ["evcbench"]
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert len(B["command"]) <= 32
    for word in B["command"]:
        assert ONE_LINE.fullmatch(word) and not word.startswith("/")
        assert ".." not in word.split("/")
    assert len(json.dumps(B).encode()) <= 64 * 1024


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_config(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert valid_name(c["name"])
    for k in ("source", "why"):
        assert ONE_LINE.fullmatch(c[k])
    assert c["file"].startswith("evcbench/")
    conf = spec.load_json(spec.ROOT / c["file"])
    assert conf["name"] == c["name"]
    assert len(c["reduced"]) <= 16
    for k in c["reduced"]:
        assert valid_name(k) and k in conf and k in conf["reduced"]
    assert sorted(conf["reduced"]) == sorted(c["reduced"])
    assert conf["frames_per_gop"] == [g[2] for g in conf["gops"]]
    committed = spec.load_json(spec.HERE / "streams"
                               / f"{conf['streams']}.json")
    assert committed["spec"] == conf["gops"]
    for p in captures.stream_paths(conf):
        assert p.exists()
    # the reference's answer is the one written with the streams
    ref = reference.load(conf)
    assert ref["md5s"] == committed["md5s"]
    assert [len(s) for s in ref["luma_sums"]] == conf["frames_per_gop"]


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_workload(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for k in ("name", "config", "traffic"):
        assert valid_name(w[k])
    assert w["chips"] in (1, 4) and ONE_LINE.fullmatch(w["why"])
    cell = spec.cell(w["name"])
    assert cell.config["name"] == w["config"]
    assert 0 < cell.traffic["gops_per_job"] <= len(cell.config["gops"])
    assert any(m["name"] != "setup_s" for m in cell.end_to_end)
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert cell.per_layer


def test_names_unique_and_pairs_once():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in B[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in B["workloads"]} == \
        {c["name"] for c in B["configs"]}


@pytest.mark.parametrize("m", B["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
    assert valid_name(m["name"]) and valid_unit(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", B["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    assert valid_name(m["name"]) and valid_unit(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    assert ONE_LINE.fullmatch(m["layer"])
    assert m["moves"] in {e["name"] for e in B["end_to_end"]}
    assert callable(spec.metric_reader(m["name"]))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")
