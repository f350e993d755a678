"""Entry: the `entry.serial` span of each call -- the MD5s and the luma
sum of the captures' numpy planes; ms a job over the window's jobs
(`evcbench/spans.py`)."""
from evcbench.spans import ms_a_job


def read(run):
    return ms_a_job(run, "entry.serial", children=True)
