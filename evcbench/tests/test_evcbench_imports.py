"""What a run and the reference load: no module whose top-level name
(the part before the first dot, compared whole) is `jax`, `jaxlib`,
`flax` or `xevd_tpu`; the reference loads nothing of `xevd_tpu_torch`
either.  Each side runs in a fresh interpreter."""
import json
import subprocess
import sys

from evcbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "xevd_tpu"}
TOPS = ("import sys, json; print(json.dumps(sorted({m.split('.')[0] "
        "for m in sys.modules})))")


def tops(code: str) -> set:
    r = subprocess.run([sys.executable, "-c", code + "\n" + TOPS],
                       cwd=spec.ROOT, capture_output=True, text=True,
                       timeout=600, check=True)
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_jax_and_nothing_of_the_program():
    got = tops("from evcbench import reference as R\n"
               "from pathlib import Path\n"
               "p = Path('evcbench/tests/data/tiny10_1.evc')\n"
               "[R.picture_md5(*x) for x in R.decode(p.read_bytes())]")
    assert not got & (FORBIDDEN | {"xevd_tpu_torch"})


def test_a_run_loads_no_jax():
    got = tops(
        "import torch\n"
        "from evcbench import run, spec\n"
        "conf = spec.load_json(spec.HERE / 'tests/data/tiny8.config.json')\n"
        "b = spec.benchmark()\n"
        "cell = spec.Cell('t', 1, conf, {'gops_per_job': 4, "
        "'warmup_jobs': 1}, b['end_to_end'], b['per_layer'])\n"
        "out = run.run_cell(cell, 7, 0.1, True, mesh=[torch.device('cpu')],"
        " log=lambda *a: None)\n"
        "assert out['correct'], out\n"
        "assert not run.foreign_modules()")
    assert "xevd_tpu_torch" in got and not got & FORBIDDEN


def _worker_tops() -> list:
    import sys
    return sorted({m.split(".")[0] for m in sys.modules})


def test_a_capture_worker_loads_no_jax():
    from evcbench import captures
    data = (spec.HERE / "tests/data/tiny8_0.evc").read_bytes()
    with captures.Workers(1) as w:
        (cap,) = w.capture([data])
        assert len(cap) == 2                      # the GOP's two pictures
        got = set(w.pool.apply(_worker_tops))
    assert "xevd_tpu_torch" in got and not got & FORBIDDEN


def test_foreign_modules_compares_whole_names():
    from evcbench import run
    assert run.foreign_modules(["xevd_tpu_torch.parallel.gop", "jaxtyping",
                                "flaxen", "numpy"]) == []
    assert run.foreign_modules(["xevd_tpu.decoder", "jax", "jaxlib.xla",
                                "flax"]) == ["flax", "jax", "jaxlib",
                                             "xevd_tpu"]
