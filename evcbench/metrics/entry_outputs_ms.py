"""Entry: the `entry.outputs` span of each call -- the checksum's read,
the output planes (`_DeviceRun.outputs`) and their MD5s; ms a job over
the window's jobs (`evcbench/spans.py`)."""
from evcbench.spans import ms_a_job


def read(run):
    return ms_a_job(run, "entry.outputs", children=True)
