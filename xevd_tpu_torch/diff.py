"""Where two decodes of a stream first differ: the counterpart of
tools/diff_backends.py:17-63 for the port.

    python -m xevd_tpu_torch.diff STREAM W H [--device cuda|cpu]
        [--ref REF.yuv] [--chroma 420|400]

Decodes STREAM with the port (`python -m xevd_tpu_torch.app`, 10-bit
output) and compares it with REF.yuv, or, without --ref, with the numpy
oracle's 10-bit decode (`tests/torch_reference.py --decode`, a program of
its own, as chip_smoke.py runs the oracle).  Prints the frame count and
whether the decodes are equal; for the first differing frame, each
differing plane's count and row and column range, its first differing
pixel with both values, and up to 40 of the 4x4 cells that hold a
difference.  Exit code 0 when equal, 1 when not."""
from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
MAX_CELLS = 40


def _planes(frame: np.ndarray, w: int, h: int, chroma: bool):
    """(name, plane) of one frame's flat uint16 samples."""
    y = frame[:w * h].reshape(h, w)
    if not chroma:
        return [("Y", y)]
    n = (w // 2) * (h // 2)
    return [("Y", y),
            ("U", frame[w * h:w * h + n].reshape(h // 2, w // 2)),
            ("V", frame[w * h + n:w * h + 2 * n].reshape(h // 2, w // 2))]


def first_diffs(a, b, w: int, h: int, chroma: str = "420") -> dict:
    """Compare two 10-bit YUV decodes (bytes or uint16 arrays) of w x h
    frames, 4:2:0 or ("400") 4:0:0.  Returns {"frames": (frames of a,
    frames of b), "equal", "frame": the first differing frame or None,
    "planes": [{"plane", "count", "rows": (first, last), "cols": (first,
    last), "first": (row, col), "a", "b": the values there, "cells": the
    top-left (row, col) of up to MAX_CELLS 4x4 cells with a difference,
    "more_cells": whether there are more}]} for that frame."""
    if chroma not in ("420", "400"):
        raise ValueError(f"chroma {chroma!r}: 420 or 400")
    has_chroma = chroma == "420"
    da = np.frombuffer(a, "<u2") if isinstance(a, bytes) else np.asarray(a)
    db = np.frombuffer(b, "<u2") if isinstance(b, bytes) else np.asarray(b)
    fsz = w * h + (2 * (w // 2) * (h // 2) if has_chroma else 0)
    if len(da) % fsz or len(db) % fsz:
        raise ValueError(f"{len(da)} / {len(db)} samples: not whole "
                         f"{w}x{h} {chroma} frames")
    na, nb = len(da) // fsz, len(db) // fsz
    out = {"frames": (na, nb), "equal": na == nb and np.array_equal(da, db),
           "frame": None, "planes": []}
    for f in range(min(na, nb)):
        fa, fb = da[f * fsz:(f + 1) * fsz], db[f * fsz:(f + 1) * fsz]
        if np.array_equal(fa, fb):
            continue
        out["frame"] = f
        for (name, pa), (_, pb) in zip(_planes(fa, w, h, has_chroma),
                                       _planes(fb, w, h, has_chroma)):
            dy, dx = np.nonzero(pa != pb)
            if not len(dy):
                continue
            cells = sorted({(int(y) // 4 * 4, int(x) // 4 * 4)
                            for y, x in zip(dy, dx)})
            out["planes"].append({
                "plane": name, "count": len(dy),
                "rows": (int(dy.min()), int(dy.max())),
                "cols": (int(dx.min()), int(dx.max())),
                "first": (int(dy[0]), int(dx[0])),
                "a": int(pa[dy[0], dx[0]]), "b": int(pb[dy[0], dx[0]]),
                "cells": cells[:MAX_CELLS],
                "more_cells": len(cells) > MAX_CELLS})
        break
    return out


def format_diffs(d: dict, a_name: str = "port", b_name: str = "ref") -> str:
    """The report of `first_diffs` as text, one plane a block."""
    na, nb = d["frames"]
    lines = [f"{na} frames ({a_name}), {nb} frames ({b_name}), "
             f"equal={d['equal']}"]
    for p in d["planes"]:
        lines.append(f"frame {d['frame']} plane {p['plane']}: {p['count']} "
                     f"diffs, rows {p['rows'][0]}..{p['rows'][1]} cols "
                     f"{p['cols'][0]}..{p['cols'][1]}")
        lines.append(f"  first at {p['first'][0]} {p['first'][1]} "
                     f"{a_name}={p['a']} {b_name}={p['b']}")
        lines.append(f"  4x4 cells: {p['cells']}"
                     f"{' ...' if p['more_cells'] else ''}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m xevd_tpu_torch.diff")
    ap.add_argument("stream", type=Path)
    ap.add_argument("w", type=int)
    ap.add_argument("h", type=int)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ref", type=Path, help="10-bit YUV to compare with "
                    "(default: the numpy oracle's decode)")
    ap.add_argument("--chroma", default="420", choices=["420", "400"])
    a = ap.parse_args(argv)
    from .app import main as app_main
    with tempfile.TemporaryDirectory() as tmp:
        port = Path(tmp) / "port.yuv"
        rc = app_main(["-i", str(a.stream), "-o", str(port),
                       "--output-bit-depth", "10", "-v", "0", "--device",
                       a.device])
        if rc != 0:
            print(f"the port's decode failed: rc {rc}", file=sys.stderr)
            return 2
        ref = a.ref
        if ref is None:
            ref = Path(tmp) / "oracle.yuv"
            r = subprocess.run([sys.executable,
                                str(REPO / "tests" / "torch_reference.py"),
                                "--decode", str(a.stream), str(ref)],
                               cwd=REPO, capture_output=True, text=True)
            if r.returncode != 0:
                print(f"the oracle's decode failed: rc {r.returncode}\n"
                      f"{r.stderr[-2000:]}", file=sys.stderr)
                return 2
        d = first_diffs(port.read_bytes(), ref.read_bytes(), a.w, a.h,
                        a.chroma)
    print(format_diffs(d, "port", "ref" if a.ref else "numpy"))
    return 0 if d["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
