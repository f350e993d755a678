"""Run the reference decoder (evcbench/oracle) over a configuration's
streams, and its control.  No run of the benchmark imports this.

    python -m evcbench.make_reference CONFIG [--write] [--control SEED ...]

CONFIG: a configuration's name (evcbench/configs/<name>.json) or the path
of a configuration file.

Each GOP is decoded in a worker process of its own (at most one a core).
It prints, for the configuration, whether every picture's MD5 equals the
MD5 written when the streams were made (evcbench/streams/<streams>.json,
by `make_streams` with this same reference: a check that the reference
has not drifted, not a second witness); with --write, and only when they
all do, it writes evcbench/streams/<streams>.oracle.json (every picture's
MD5 and luma sum, which a run compares with).

--control: the control of `correct` at the configuration's own size.  The
reference's own pictures, rounded to the next precision below the
stream's (`reference.lower_precision`), are put in the program's place and
compared by `reference.compare`, as a run compares the program's, over one
job of each SEED (the whole pool in the order the seed draws); it prints
each job's numbers beside their limits.  The control has to fail."""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import platform
import sys
import time
from pathlib import Path

from . import reference as R
from . import spec, traffic
from .captures import stream_paths


def _gop(path: str) -> dict:
    t0 = time.perf_counter()
    with open(path, "rb") as f:
        pics = R.decode(f.read())
    return {"md5s": [R.picture_md5(p, bd) for p, bd in pics],
            "luma_sums": [R.luma_sum(p) for p, _ in pics],
            "seconds": time.perf_counter() - t0,
            "planes": [p for p, _ in pics]}


def _control(config: dict, planes: list) -> dict:
    bd = config["bit_depth"]
    low = [[R.lower_precision(p, bd) for p in gop] for gop in planes]
    return {"md5s": [[R.picture_md5(p, bd) for p in gop] for gop in low],
            "luma_sums": [[R.luma_sum(p) for p in gop] for gop in low]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m evcbench.make_reference")
    ap.add_argument("config")
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--control", type=int, nargs="*", default=[])
    a = ap.parse_args(argv)
    config = spec.load_json(Path(a.config) if a.config.endswith(".json")
                            else spec.HERE / "configs" / f"{a.config}.json")
    paths = [str(p) for p in stream_paths(config)]
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            min(len(paths), os.cpu_count() or 1), mp_context=ctx) as pool:
        gops = list(pool.map(_gop, paths))
    wall = time.perf_counter() - t0
    committed = spec.load_json(spec.HERE / "streams"
                               / f"{config['streams']}.json")["md5s"]
    name = config["name"]
    md5s = [g["md5s"] for g in gops]
    equal = md5s == committed
    print(f"{name}: {sum(map(len, md5s))} pictures decoded by the "
          f"reference in {wall:.1f} s (GOPs "
          f"{[round(g['seconds'], 1) for g in gops]} s); equal to the "
          f"MD5s written with the streams: {equal}", flush=True)
    if a.write:
        if not equal:
            print("not written: the reference differs from the MD5s "
                  "written with the streams", file=sys.stderr)
            return 1
        rec = {"made_by": f"python -m evcbench.make_reference {name} "
                          "--write",
               "where": f"{platform.machine()}, {os.cpu_count()} cores, a "
                        "worker process a GOP",
               "seconds": [g["seconds"] for g in gops],
               "md5s": md5s, "luma_sums": [g["luma_sums"] for g in gops]}
        R.reference_path(config).write_text(json.dumps(rec, indent=1) + "\n")
    if a.control:
        ref = {"md5s": md5s, "luma_sums": [g["luma_sums"] for g in gops]}
        ctl = _control(config, [g["planes"] for g in gops])
        whole = {"gops_per_job": len(gops)}
        for seed in a.control:
            order = next(traffic.job_orders(whole, len(gops), seed))
            job = (order, [ctl["md5s"][g] for g in order],
                   sum(sum(ctl["luma_sums"][g]) for g in order))
            got = R.compare([job], ref)
            print(json.dumps({"config": name, "seed": seed,
                              "control": {k: {"value": got[k], "limit": v}
                                          for k, v in R.LIMITS.items()},
                              "pictures": got["pictures"],
                              "correct": all(got[k] <= v for k, v
                                             in R.LIMITS.items())}),
                  flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
