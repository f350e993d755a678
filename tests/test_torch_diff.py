"""The port's diff tool (xevd_tpu_torch/diff.py) on the CPU: two equal
decodes report equal; a single changed sample (in U of frame 1 for 4:2:0,
in Y of frame 1 for 4:0:0, which has no U) is reported at its frame,
plane, pixel and 4x4 cell; frame counts that differ report unequal; and
the command line on a generated stream, against its own decode, an
altered copy and the numpy oracle's decode (tests/torch_reference.py
--decode)."""
import numpy as np
import pytest

from xevd_tpu_torch import diff as D

from .test_torch_slice import _decode, _stream

W, H = 16, 8


def _frames(n, chroma, seed=0):
    fsz = W * H + (2 * (W // 2) * (H // 2) if chroma == "420" else 0)
    return np.random.default_rng(seed).integers(0, 1024, n * fsz,
                                                dtype=np.uint16), fsz


@pytest.mark.parametrize("chroma", ["420", "400"])
def test_equal_decodes_report_equal(chroma):
    a, _ = _frames(3, chroma)
    d = D.first_diffs(a, a.copy(), W, H, chroma)
    assert d == {"frames": (3, 3), "equal": True, "frame": None,
                 "planes": []}
    assert D.first_diffs(a.tobytes(), a.tobytes(), W, H, chroma)["equal"]
    assert "3 frames (port), 3 frames (ref), equal=True" in D.format_diffs(d)


@pytest.mark.parametrize("chroma,plane,offset,y,x", [
    ("420", "U", W * H, 3, 5),       # U of frame 1, row 3, column 5
    ("400", "Y", 0, 6, 13),          # 4:0:0: Y of frame 1, row 6, col 13
])
def test_one_changed_sample_is_found(chroma, plane, offset, y, x):
    a, fsz = _frames(3, chroma, seed=1)
    b = a.copy()
    pw = W if plane == "Y" else W // 2
    i = fsz + offset + y * pw + x            # frame 1
    b[i] ^= 7
    d = D.first_diffs(a, b, W, H, chroma)
    assert not d["equal"] and d["frame"] == 1
    [p] = d["planes"]
    assert p == {"plane": plane, "count": 1, "rows": (y, y), "cols": (x, x),
                 "first": (y, x), "a": int(a[i]), "b": int(b[i]),
                 "cells": [(y // 4 * 4, x // 4 * 4)], "more_cells": False}
    text = D.format_diffs(d)
    assert f"frame 1 plane {plane}: 1 diffs, rows {y}..{y} cols {x}..{x}" \
        in text
    assert f"first at {y} {x} port={a[i]} ref={b[i]}" in text
    assert f"4x4 cells: [({y // 4 * 4}, {x // 4 * 4})]" in text


def test_cells_are_capped_and_counts_compared():
    a, fsz = _frames(2, "400", seed=2)
    b = a.copy()
    b[fsz:] ^= 1                             # every sample of frame 1
    d = D.first_diffs(a, b, W, H, "400")
    [p] = d["planes"]
    assert p["count"] == W * H and len(p["cells"]) == (W // 4) * (H // 4)
    big_w, big_h = 64, 48                    # 192 cells: capped at 40
    c = np.zeros(big_w * big_h, np.uint16)
    d = D.first_diffs(c, c + 1, big_w, big_h, "400")
    assert len(d["planes"][0]["cells"]) == D.MAX_CELLS
    assert d["planes"][0]["more_cells"]
    d = D.first_diffs(a, a[:fsz], W, H, "400")
    assert d["frames"] == (2, 1) and not d["equal"] and d["frame"] is None
    with pytest.raises(ValueError):
        D.first_diffs(a[:-1], a, W, H, "400")


def test_command_line_on_a_stream(fixtures_dir, tmp_path, capsys):
    """The port's CPU decode against its own output (equal, rc 0), an altered
    copy (rc 1, the pixel found) and the numpy oracle (equal)."""
    stream = _stream(fixtures_dir, "p64", 64, 64, 4, 30, 6, "IPPP")
    rc, ref = _decode(stream, tmp_path / "t.yuv", "torch")
    assert rc == 0
    fsz = 64 * 64 * 3
    bad = bytearray(ref)
    i = fsz + 64 * 64 * 2 + 2 * (10 * 32 + 17)   # frame 1, U row 10, col 17
    bad[i] ^= 1
    (tmp_path / "bad.yuv").write_bytes(bytes(bad))
    args = [str(stream), "64", "64", "--device", "cpu"]
    assert D.main(args + ["--ref", str(tmp_path / "t.yuv")]) == 0
    assert "4 frames (port), 4 frames (ref), equal=True" in \
        capsys.readouterr().out
    assert D.main(args + ["--ref", str(tmp_path / "bad.yuv")]) == 1
    out = capsys.readouterr().out
    assert "frame 1 plane U: 1 diffs, rows 10..10 cols 17..17" in out
    assert "4x4 cells: [(8, 16)]" in out
    assert D.main(args) == 0
    assert "4 frames (port), 4 frames (numpy), equal=True" in \
        capsys.readouterr().out
