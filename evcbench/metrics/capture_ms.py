"""Host half: the capture of a job's GOPs by the worker processes
(`captures.py`: the port's parse, entropy decode, derive and pack, and its
numpy decode of every picture), host clock from handing the workers the
stream bytes to the last capture received; ms a job over the window's
jobs."""


def read(run):
    got = [j.capture_s for j in run.jobs]
    if not got or None in got:
        return None
    return 1e3 * sum(got) / len(got)
