"""evcbench -- the benchmark of the EVC decoder's PyTorch and CUDA port
(`xevd_tpu_torch`) on NVIDIA GPUs.  It measures GOP-batch decode jobs
from stream bytes to pictures: the port's host half captures each GOP in
a worker process, then one call of
`xevd_tpu_torch.parallel.gop.decode_gops_sharded` decodes the job's GOPs
as a batch on the card; every output picture is held to a reference
decoder.

Run one cell once, from the root of a checkout (BENCHMARK.json lists the
cells):

    python3 -m evcbench.run --workload gop1080-base-short --seed 7 \\
        --seconds 30 --trace 0

The last line of standard output is one JSON object (`run.py` says what
it holds).  Without a CUDA device it exits 3 and prints no result.

What sits where.  Everything of one configuration, traffic mix or metric
is a file of its own, found by the name BENCHMARK.json gives it; a later
cell, configuration or metric is added as files and entries, without an
edit to a file that is here:

  configs/<name>.json     a configuration: its source, its GOP streams'
                          `encode_stream` parameters (`gops`, in the order
                          `encode_stream_order` names), the prefix of its
                          streams under streams/, its guarantee, and what
                          was `reduced` and `assumed`
  traffic/<name>.json     a traffic mix, read by the one generator,
                          traffic.py (GOPs a job, warm-up jobs; a key
                          that nothing reads is refused)
  metrics/<name>.py       a per-layer metric: `read(run)` returns its
                          number from the run's marks, trace and work
                          (run.py `Run`), or None where it finds nothing
  streams/                each configuration's committed GOP streams
                          (<prefix>_<g>.evc), their specs and the MD5s
                          made when they were encoded (<prefix>.json),
                          and the reference's answer a run compares with
                          (<prefix>.oracle.json)

The yardstick: traffic.py (the job orders), trace.py (marks, the reading
of a profiler trace), work.py (bytes, operations and the card's peaks for
the kernels' roofline), reference.py (what decides `correct`) and
oracle/, the reference decoder, a frozen copy of the numpy oracle.  From
the program a run takes only the entry above, its capture function
(captures.py runs it in worker processes), its marks and its kernels'
names.  The port's host half was copied from the same code as oracle/,
so `correct` holds the device half to an independent reference and the
host half only to that frozen copy: no normative decoder's output is in
the repo.

Streams.  A configuration's streams were made by the repo's seeded
encoder (tools/evc_enc.py) from its `gops` specs: `python -m
evcbench.make_streams CONFIG_FILE` makes them anew on any host (minutes a
1080p picture), and `python -m evcbench.make_reference NAME --write`
writes the reference's answer.  No run imports either.

Tests: `python -m pytest evcbench/tests -q` on a CPU (the harness
on 64x64 test streams with the port's plain versions, the control, the
planted faults, the metrics' arithmetic, the files); `-m cuda` on a card.
"""
