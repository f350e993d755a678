"""Kernels: the device time of the batched Baseline intra scan
(`csrc/intra.cu`: its writer and its persistent scan kernel) in the
window's jobs, from the profiler's trace; ms a job.  The scan is bound by
its chain of CUs, so no roofline is given for it."""

KERNELS = ("intra_writer_kernel", "intra_scan_kernel")


def read(run):
    if run.trace is None or not run.jobs:
        return None
    us = sum(run.trace.kernel_us(k) for k in KERNELS)
    return us / 1e3 / len(run.jobs) if us > 0 else None
