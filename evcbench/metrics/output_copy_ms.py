"""Batched step: the device checksum and the device-to-host copies of a
step's cropped pictures, CUDA events from the "step" mark to "output",
summed over a job's steps; ms a job over the window's jobs."""


def read(run):
    got = [j.marks.device_ms("step", "output") for j in run.jobs]
    if not got or None in got:
        return None
    return sum(got) / len(got)
