"""Host half: the self time of the decoder's `host.parse` spans in a job's
captures -- each `Decoder.decode` less the spans inside it: the NAL unit
header, SPS, PPS and slice header, the POC and the reference lists --
summed over the job's GOPs (each in its worker); ms a job over the
window's jobs (`evcbench/spans.py`)."""
from evcbench.spans import ms_a_job


def read(run):
    return ms_a_job(run, "host.parse")
