"""Kernels: the bytes-bound batched kernels' share of their roofline in
the window's jobs -- the sum of each launch's least time (`work.py`:
max(bytes / 3.35 TB/s, operations / 67 T/s), from each job's own tables)
over the sum of their device times in the profiler's trace.  The
operations' peak is an assumed upper one (`work.py`); the card's power
limit is printed with every run."""
from evcbench.work import KERNELS


def read(run):
    if run.trace is None or not run.jobs:
        return None
    us = sum(run.trace.kernel_us(k) for k in KERNELS.values())
    if us <= 0:
        return None
    return 100.0 * sum(run.bounds.values()) * 1e6 / us
