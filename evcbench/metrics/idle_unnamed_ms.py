"""Device: the card's idle time in each job, from its first `capture.gop`
start to the end of its call, that lies under no program span of any
process (the workers' and the parent's, placed on the trace's clock by
the job's decode anchor); ms a job over the window's jobs
(`evcbench/spans.py`).  Its reading also writes the spans' partition of
each job, the clock's check and the idle time by innermost span to
standard error."""
import sys

from evcbench.spans import idle_unnamed_ms, report


def read(run):
    for line in report(run):
        print(line, file=sys.stderr, flush=True)
    return idle_unnamed_ms(run)
