"""Job staging: the kernel stream's wait for its step's copies, CUDA
events from the "start" mark to "wait" (the copy into the slot, the two
copies on the upload stream and the wait for them), summed over a job's
steps; ms a job over the window's jobs."""


def read(run):
    got = [j.marks.device_ms("start", "wait") for j in run.jobs]
    if not got or None in got:
        return None
    return sum(got) / len(got)
