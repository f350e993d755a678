"""The port's benchmark (`python -m xevd_tpu_torch.bench`) on a parent
checkout and on this tree, in one call on one card, in turns: parent,
this tree, this tree, parent (with --pairs N, N such pairs, each after
the first in the other order than the one before: P C C P P C ...).

    python tests/torch_bench_compare.py PARENT [--only c2,c3,gop]
        [--pairs 2]

PARENT is another checkout of the repository (e.g. a `git archive` of the
parent commit unpacked under build/, which is gitignored).  This tree's
bench workers make the streams and the numpy oracle's MD5s once
(`bench.prepare`), they are copied into PARENT's stream cache, and each
tree captures the GOPs with its own port (a capture is a pickle of that
port's pack); only then does any clock start.  The streams and MD5s are
also copied to chiprun_out/fixtures/ (put them under tests/fixtures/ to
skip their generation in a later call).  Each run's log goes to
chiprun_out/bench_compare_<i>_<tree>.log; one JSON line a run gives its
headline numbers (frames/s of configs 2 and 3 and of the GOP batch, the
median of the bench's 5 runs with every run, config 3's pack, slot wait,
upload and H2D split, the GOP steps' upload split).  With the GOP batch,
each tree then decodes it 5 more times with CUDA events around every
step's Baseline intra scan (`ops/pipeline.py` `intra_scan`, wrapped: the
same cut in either tree, whatever its own marks), one JSON line a tree.
The last line holds them all with the card's name and power limit."""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "chiprun_out"


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def prepare(tree: Path, names: list[str]):
    subprocess.run([sys.executable, "-c",
                    "from xevd_tpu_torch import bench as B; "
                    f"B.prepare({names!r})"], cwd=tree, check=True)


def bench(tree: Path, log: Path, only: str) -> dict:
    with open(log, "w") as f:
        subprocess.run([sys.executable, "-m", "xevd_tpu_torch.bench",
                        "--only", only], cwd=tree, stdout=f,
                       stderr=subprocess.STDOUT, check=True)
    return json.loads(log.read_text().strip().splitlines()[-1])


# run in a tree: its own port decodes the bench's GOP batch 5 times with
# CUDA events around each step's intra scan; prints [[ms a step] a run]
SCAN_TIMES = r"""
import json, torch
from xevd_tpu_torch import bench as B
from xevd_tpu_torch.ops import pipeline as P
from xevd_tpu_torch.parallel import gop as TG
caps = B.prepare(["gop"])[1]
# {batch: (captures, committed MD5s)} since the GOP streams are committed,
# a list of captures before
caps = caps["gop"][0] if isinstance(caps, dict) else caps
dev = torch.device("cuda", 0)
events, scan = [], P.intra_scan
def timed(*a, **k):
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out = scan(*a, **k)
    ev[1].record()
    events.append(ev)
    return out
P.intra_scan = timed
runs = []
for _ in range(5):
    events.clear()
    dmd5, smd5 = TG.decode_gops_sharded(None, mesh=[dev], captures=caps)
    torch.cuda.synchronize()
    assert dmd5 == smd5, "a GOP frame differs from the serial oracle"
    runs.append([a.elapsed_time(b) for a, b in events])
print(json.dumps(runs))
"""


def scan_times(tree: Path) -> list:
    out = subprocess.run([sys.executable, "-c", SCAN_TIMES], cwd=tree,
                         capture_output=True, text=True, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def summary(r: dict) -> dict:
    """The numbers PERF.md keeps from one bench run: each config's
    frames/s (median, runs, spread), host ms a frame inside
    `Decoder.decode` of each timed run, split, traced H2D and busy
    share; the GOP batch's frames/s, batch ms and step split."""
    keys = ("wall_ms", "pack_ms", "slot_wait_ms", "slot_waits",
            "upload_host_ms", "upload_device_ms", "device_stages_ms",
            "entropy_ms", "derive_ms", "d2h_ms")
    out = {}
    for name, c in r["configs"].items():
        out[name] = {"fps": c["fps_median"], "runs": c["fps_runs"],
                     "spread": c["fps_spread"],
                     "host_ms_runs": c["host_ms_per_frame_runs"],
                     "split": {k: c["split"].get(k) for k in keys},
                     "traced_h2d_ms": (c["traced"] or {}).get("h2d_ms"),
                     "busy_share": (c["traced"] or {}).get("busy_share")}
    g = r["gop"]
    if g:
        out["gop"] = {"fps": g["fps_median"], "runs": g["fps_runs"],
                      "spread": g["fps_spread"], "ms_runs": g["ms_runs"],
                      "split_ms": g.get("split_ms"),
                      "steps": g["step_split"]}
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--only", default="c2,c3,gop")
    ap.add_argument("--pairs", type=int, default=2)
    a = ap.parse_args(argv)
    parent = a.parent.resolve()
    names = a.only.split(",")
    OUT.mkdir(exist_ok=True)
    card = smi()
    print(card, flush=True)
    prepare(REPO, names)
    (parent / "tests" / "fixtures").mkdir(parents=True, exist_ok=True)
    for f in (REPO / "tests" / "fixtures").glob("torch_bench_*"):
        shutil.copy2(f, parent / "tests" / "fixtures" / f.name)
    prepare(parent, names)
    keep = OUT / "fixtures"          # the streams, for a later call
    keep.mkdir(exist_ok=True)
    for f in (REPO / "tests" / "fixtures").glob("torch_bench_*"):
        shutil.copy2(f, keep / f.name)
    pair = [("parent", parent), ("change", REPO)]
    order = [t for k in range(a.pairs) for t in (pair if k % 2 == 0
                                                 else pair[::-1])]
    runs = []
    for i, (name, tree) in enumerate(order, 1):
        r = summary(bench(tree, OUT / f"bench_compare_{i}_{name}.log",
                          a.only))
        runs.append({"run": i, "tree": name, **r})
        print(json.dumps(runs[-1]), flush=True)
    scans = {}
    if "gop" in names:
        for name, tree in pair:
            runs_ms = scan_times(tree)
            scans[name] = {"ms_runs": runs_ms, "step_median_ms": [
                sorted(r[t] for r in runs_ms)[len(runs_ms) // 2]
                for t in range(len(runs_ms[0]))]}
            print(json.dumps({"tree": name, "intra_scan": scans[name]}),
                  flush=True)
    print(smi(), flush=True)
    print(json.dumps({"card": card, "runs": runs, "intra_scan": scans}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
