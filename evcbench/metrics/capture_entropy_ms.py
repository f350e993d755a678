"""Host half: the decoder's `host.entropy` spans in a job's captures --
the C engine's `decode_slice_native` (or `_main`, or the Python
`EntropyDecoder`) -- summed over the job's GOPs; ms a job over the
window's jobs (`evcbench/spans.py`)."""
from evcbench.spans import ms_a_job


def read(run):
    return ms_a_job(run, "host.entropy")
