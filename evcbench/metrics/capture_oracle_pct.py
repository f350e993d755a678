"""Host half: the share of a job's captured pictures that the numpy
oracle also decoded -- 100 x the counter `capture.oracle_pictures` over
`capture.pictures`, both counted in the capture workers
(`parallel/gop.py` `_capture_gop`) and summed over the window's jobs
(`evcbench/spans.py` `window`); %.  None where the program counts no
`capture.pictures`."""
from evcbench.spans import window


def read(run):
    got = window(run)
    if got is None:
        return None
    pictures = sum(r.counts.get("capture.pictures", 0) for _, _, r in got)
    if not pictures:
        return None
    oracle = sum(r.counts.get("capture.oracle_pictures", 0)
                 for _, _, r in got)
    return 100.0 * oracle / pictures
