"""Host half: the `capture.pack` spans in a job's captures -- each
picture's `ops/pack.pack_frame` in `parallel/gop.py` `_Capture` -- summed
over the job's GOPs; ms a job over the window's jobs
(`evcbench/spans.py`)."""
from evcbench.spans import ms_a_job


def read(run):
    return ms_a_job(run, "capture.pack")
