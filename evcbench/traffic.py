"""The one traffic generator: a traffic mix is a data file
(`traffic/<name>.json`) that this module reads.

A job is `gops_per_job` GOPs of the configuration's pool, each at most
once, in an order drawn from the run's seed.  A permutation of the whole
pool does the same work in every job and under every seed: the order only
moves GOPs between the batch's slots and the DPB ring's entries (the entry
sorts a device's GOPs by length, so the order decides among GOPs of one
length)."""
from __future__ import annotations

import numpy as np

# what a traffic file may hold: `what` describes it, the others are read
KEYS = {"what", "gops_per_job", "warmup_jobs"}


def check(traffic: dict, name: str = "traffic") -> dict:
    """`traffic`, or ValueError where it holds a key that nothing reads
    or lacks one that is read."""
    unknown, missing = set(traffic) - KEYS, KEYS - {"what"} - set(traffic)
    if unknown or missing:
        raise ValueError(f"{name}: keys {sorted(unknown)} are not read, "
                         f"{sorted(missing)} are missing")
    return traffic


def job_orders(traffic: dict, pool: int, seed: int):
    """An endless iterator of jobs, each a list of GOP indices into the
    pool, drawn from `seed` (any whole number; the same seed gives the
    same jobs)."""
    k = int(traffic["gops_per_job"])
    if not 0 < k <= pool:
        raise ValueError(f"gops_per_job {k} of a pool of {pool} GOPs")
    rng = np.random.default_rng(int(seed) % (1 << 64))
    while True:
        yield [int(g) for g in rng.permutation(pool)[:k]]
