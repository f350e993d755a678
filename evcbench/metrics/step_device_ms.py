"""Batched step: `ops/pipeline.py` `run_frames_device`, CUDA events from
the "wait" mark to "step", summed over a job's steps; ms a job over the
window's jobs."""


def read(run):
    got = [j.marks.device_ms("wait", "step") for j in run.jobs]
    if not got or None in got:
        return None
    return sum(got) / len(got)
