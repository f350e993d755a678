"""Host half: from the latest `capture.gop` span's end in a job to its
`entry.plan` span's start -- the captures pickled in the workers, piped
and unpickled in the parent, up to the entry's plan; ms a job over the
window's jobs (`evcbench/spans.py`)."""
from evcbench.spans import capture_return_ms


def read(run):
    return capture_return_ms(run)
