"""Entry: the window's pictures over the sum of its jobs' decode seconds by
the entry's own clock (`decode_gops_sharded`'s `stats["seconds"]`: first
upload to last output on the host), frames/s.  Not a median of jobs.  The
device half of `job_fps`, which also waits for the captures and the
entry's work outside its clock."""


def read(run):
    if run.decode_s <= 0:
        return None
    return sum(j.frames for j in run.jobs) / run.decode_s
