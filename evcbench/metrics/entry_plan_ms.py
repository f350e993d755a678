"""Entry: the host time from the call of `decode_gops_sharded` to its
first step's first mark -- the plan (`_plan`: every step stacked) and the
allocation of a new `_DeviceRun` (pinned staging slots and output buffers,
the DPB ring), before the entry's clock starts; ms a job."""


def read(run):
    if not run.jobs:
        return None
    return 1e3 * sum(j.plan_s for j in run.jobs) / len(run.jobs)
