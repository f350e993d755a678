"""Host half: the decoder's `host.derive` spans in a job's captures --
`job_from_native`, `derive_frame_native_main` or `derive_frame` -- summed
over the job's GOPs; ms a job over the window's jobs
(`evcbench/spans.py`)."""
from evcbench.spans import ms_a_job


def read(run):
    return ms_a_job(run, "host.derive")
