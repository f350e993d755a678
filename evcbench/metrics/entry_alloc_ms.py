"""Entry: the `entry.alloc` span of each call -- the `_DeviceRun`s built
(pinned staging slots, the DPB ring, the output buffers); ms a job over
the window's jobs (`evcbench/spans.py`)."""
from evcbench.spans import ms_a_job


def read(run):
    return ms_a_job(run, "entry.alloc", children=True)
