"""Job staging: the bytes `ops/pack.stage_batch` copies into the pinned
slots (the counter `stage.bytes`) over the host time from each step's
"start" mark to its "stage" mark (what `stage_ms` measures), summed over
the window's jobs; GB/s (`evcbench/spans.py`)."""
from evcbench.spans import stage_gbps


def read(run):
    return stage_gbps(run)
