"""The stage-diff mode of the port's diff tool (`python -m
xevd_tpu_torch.diff --stages`, the counterpart of tools/stage_diff.py and
tools/stage_diff2.py) on the CPU, on a small Baseline stream against the
numpy oracle's processes (tests/torch_reference.py --decode --knockout):
with one chroma vertical strength raised on the port's side only, the
two agree with deblocking off and under `nover` and differ under `nohor`
and `noluma`; without the plant they agree under every mode; the
knock-outs themselves, on a job's maps; and the command line's refusals."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from xevd_tpu_torch import diff as D

from .test_torch_slice import _stream
from .torch_helpers import raise_chroma_ver_strength

W, H = 96, 48
REPO = Path(__file__).resolve().parent.parent


def _small(fixtures_dir):
    return _stream(fixtures_dir, "i96x48", W, H, 2, 27, 4, "I")


def test_stage_diff_places_a_planted_chroma_ver_fault(fixtures_dir):
    d = D.stage_diffs(_small(fixtures_dir), W, H, device="cpu",
                      port_hook=raise_chroma_ver_strength)
    assert list(d) == ["none", *D.KNOCKOUTS]
    assert not d["none"]["equal"]
    assert d["nodb"]["equal"] and d["nover"]["equal"]
    assert not d["nohor"]["equal"] and not d["noluma"]["equal"]
    for m in ("none", "nohor", "noluma"):
        assert d[m]["frames"] == (2, 2)
        assert [p["plane"] for p in d[m]["planes"]] == ["U"]
    assert D.first_agreeing(d) == "nodb"
    text = D.format_stages(d)
    assert "first knock-out under which they agree: nodb" in text
    assert "nohor   differ: frame 0 plane U" in text


def test_stage_diff_reports_agreement_on_the_clean_stream(fixtures_dir):
    """Without the plant, every mode agrees; with --frame 1 only the second
    output frame is compared."""
    d = D.stage_diffs(_small(fixtures_dir), W, H, device="cpu", frame=1)
    assert all(x["equal"] and x["frames"] == (1, 1) for x in d.values())
    assert "the decodes agree without a knock-out" in D.format_stages(d)


class _Ns:
    """A bare namespace for a job and its frame state."""


def _job(rng):
    job, job.fs, job.fs.sh = _Ns(), _Ns(), _Ns()
    job.fs.sh.deblocking_filter_on = 1
    for n in ("db_ver_y", "db_hor_y", "db_ver_u", "db_hor_u", "db_ver_v",
              "db_hor_v"):
        setattr(job, n, rng.integers(1, 5, (4, 6)).astype(np.int32))
    job.addb_luma = rng.integers(1, 5, (2, 4, 6, 4)).astype(np.int32)
    job.addb_chroma = rng.integers(1, 5, (2, 4, 6, 7)).astype(np.int32)
    return job


@pytest.mark.parametrize("mode", ["none", *D.KNOCKOUTS])
def test_knock_out_zeroes_its_maps_only(mode):
    """Each mode zeroes its strengths (Baseline maps, and the bs of its
    edges in the ADDB maps), leaves the rest as they were and writes into
    no array it was given; "nodb" turns the slice's deblocking off."""
    rng = np.random.default_rng(3)
    job = _job(rng)
    before = {k: np.array(v) for k, v in vars(job).items() if k != "fs"}
    given = {k: v for k, v in vars(job).items() if k != "fs"}
    D.knock_out(job, mode)
    zeroed = {"none": (), "nodb": ("db_ver_y", "db_hor_y", "db_ver_u",
                                   "db_hor_u", "db_ver_v", "db_hor_v"),
              "nover": ("db_ver_u", "db_ver_v"),
              "nohor": ("db_hor_u", "db_hor_v"),
              "noluma": ("db_ver_y", "db_hor_y")}[mode]
    for k, v in before.items():
        np.testing.assert_array_equal(given[k], v)      # never written into
        if k.startswith("db_"):
            assert (getattr(job, k) == 0).all() == (k in zeroed), k
    if mode == "nodb":
        assert job.fs.sh.deblocking_filter_on == 0
        assert job.addb_luma is None and job.addb_chroma is None
        return
    assert job.fs.sh.deblocking_filter_on == 1
    bs = {"nover": ("addb_chroma", 0), "nohor": ("addb_chroma", 1),
          "noluma": ("addb_luma", None)}.get(mode)
    for k in ("addb_luma", "addb_chroma"):
        got, want = getattr(job, k), before[k].copy()
        if bs and bs[0] == k:
            want[slice(None) if bs[1] is None else bs[1], ..., 0] = 0
        np.testing.assert_array_equal(got, want)


def test_stage_diff_command_line_refusals(capsys):
    with pytest.raises(ValueError, match="knock-out"):
        D.knock_out(object(), "nochroma")
    for argv in (["--stages", "s.evc", "8", "8", "--ref", "r.yuv"],
                 ["s.evc", "8", "8", "--frame", "1"]):
        with pytest.raises(SystemExit):
            D.main(argv)


def test_oracle_process_loads_no_torch(fixtures_dir, tmp_path):
    """The oracle's side of --stages (tests/torch_reference.py --decode
    --knockout) decodes under a knock-out without loading torch or the
    port's device code: the port's host half and `knockout.py` alone."""
    code = ("import sys; from pathlib import Path; "
            "from tests.torch_reference import numpy_decode; "
            f"numpy_decode(Path({str(_small(fixtures_dir))!r}), "
            f"Path({str(tmp_path / 'o.yuv')!r}), 'nover'); "
            "print(sorted(m for m in sys.modules if m == 'torch' or "
            "m.startswith('xevd_tpu_torch.ops')))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split("\n")[-2] == "[]"
    assert (tmp_path / "o.yuv").stat().st_size == 2 * W * H * 3
