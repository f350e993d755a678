"""Entry: the host time of a call after the entry's clock stops -- the
checksum's read, the MD5s of every output picture and of every captured
oracle picture, and the captures' luma sum; ms a job."""


def read(run):
    if not run.jobs:
        return None
    return 1e3 * sum(j.wall - j.plan_s - j.seconds
                     for j in run.jobs) / len(run.jobs)
