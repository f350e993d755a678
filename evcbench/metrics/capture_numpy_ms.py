"""Host half: the `capture.numpy` spans in a job's captures with their
child `capture.numpy.deblock` -- each picture's numpy decode
(`NumpyPixelBackend.decode_frame`), for the entry's own check -- summed
over the job's GOPs; ms a job over the window's jobs
(`evcbench/spans.py`)."""
from evcbench.spans import ms_a_job


def read(run):
    return ms_a_job(run, "capture.numpy", children=True)
