"""Job staging: the host's copy of each step's stacked arrays into its
pinned slot (`parallel/gop.py` `_DeviceRun.step`, `ops/pack.stage_batch`,
`ops/staging.py`), host clock from the "start" mark to "stage", summed
over a job's steps; ms a job over the window's jobs."""


def read(run):
    if not run.jobs:
        return None
    return sum(j.marks.host_ms("start", "stage") for j in run.jobs) / len(
        run.jobs)
