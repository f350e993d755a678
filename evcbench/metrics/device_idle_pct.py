"""Device: the share of the jobs' decode time (the entry's own clock) in
which nothing ran on the card -- 100 less the union of the kernels,
copies and memsets that the decodes issued, from the profiler's trace,
over the sum of the decodes' seconds."""


def read(run):
    if run.trace is None or run.decode_s <= 0 \
            or not run.trace.decode_device():
        return None
    return 100.0 * (1.0 - run.trace.busy_us(decode_only=True) / 1e6
                    / run.decode_s)
