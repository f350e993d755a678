"""Where two decodes of a stream first differ: the counterpart of
tools/diff_backends.py:17-63 for the port, and with --stages of
tools/stage_diff.py and tools/stage_diff2.py.

    python -m xevd_tpu_torch.diff STREAM W H [--device cuda|cpu]
        [--ref REF.yuv] [--chroma 420|400]
    python -m xevd_tpu_torch.diff --stages STREAM W H [--frame N]
        [--device cuda|cpu] [--chroma 420|400]

Decodes STREAM with the port (`python -m xevd_tpu_torch.app`, 10-bit
output) and compares it with REF.yuv, or, without --ref, with the numpy
oracle's 10-bit decode (`tests/torch_reference.py --decode`, a program of
its own, as chip_smoke.py runs the oracle).  Prints the frame count and
whether the decodes are equal; for the first differing frame, each
differing plane's count and row and column range, its first differing
pixel with both values, and up to 40 of the 4x4 cells that hold a
difference.  Exit code 0 when equal, 1 when not.

--stages bisects a difference down to a deblock stage: it decodes STREAM
with the port and with the numpy oracle (`tests/torch_reference.py
--decode --knockout MODE`, one process a mode, all started together) as
they are ("none") and under each knock-out of the originals, in the order
KNOCKOUTS: "nodb" turns deblocking off (tools/stage_diff.py), "nover",
"nohor" and "noluma" zero the chroma vertical, chroma horizontal and luma
strengths (tools/stage_diff2.py; on the ADDB path the bs of those edges).
`knock_out` applies a mode to each frame's job before its pixels, on both
sides alike, by a wrapper of the backend's `decode_frame` that the tool
installs: the decoder and its host code are untouched.  It prints, for
each mode, whether the two agree and else the first differing frame,
plane and pixel, then the first knock-out under which they agree.  With
--frame N both sides decode the first N + 1 output frames and only frame
N is compared.  Exit code 0 when the decodes agree without a knock-out,
1 when not."""
from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from .knockout import KNOCKOUTS, knock_out
from .ops.pipeline import TorchPixelBackend

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


def port_decode(data: bytes, out: Path, backend, frames: int = 0) -> int:
    """Decode a length-prefixed NAL unit stream with the port's `Decoder`
    on `backend` (`bench.decode`'s loop) to 10-bit YUV in `out`, the first
    `frames` output frames (0: all), as the CLI writes it; returns the
    frames written."""
    from .bench import decode
    from .host.utils.yuv import YuvWriter

    writer = None

    def write(f):
        nonlocal writer
        if writer is None:
            writer = YuvWriter(str(out), f.y.shape[1], f.y.shape[0], 10,
                               f.chroma_format_idc)
        writer.write(f)
    try:
        got, _, _ = decode(data, backend, on_output=write, limit=frames)
    finally:
        if writer:
            writer.close()
    if writer is None:
        out.write_bytes(b"")
    return len(got)


class _KnockedOut(TorchPixelBackend):
    """The port's backend with knock-out `mode` applied to each frame's
    job, after `hook(job)` where given."""

    def __init__(self, device, mode, hook=None):
        super().__init__(device=device)
        self.mode, self.hook = mode, hook

    def decode_frame(self, job, sps, refp):
        if self.hook is not None:
            self.hook(job)
        knock_out(job, self.mode)
        return super().decode_frame(job, sps, refp)


def _oracle(stream: Path, out: Path, mode: str, frames: int):
    """Start the numpy oracle's decode under knock-out `mode`, a program of
    its own (tests/torch_reference.py --decode)."""
    return subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_reference.py"),
         "--decode", str(stream), str(out), "--knockout", mode,
         "--frames", str(frames)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def stage_diffs(stream: Path, w: int, h: int, device="cuda", frame=None,
                chroma="420", port_hook=None) -> dict:
    """The port's decode of `stream` against the numpy oracle's as they are
    and under each knock-out (see the module docstring): {mode:
    `first_diffs` of the two}, mode "none" first, then KNOCKOUTS in order;
    with `frame`, of that output frame alone.  `port_hook(job)`, if given,
    runs on the port's side only, before the knock-out (a planted fault,
    for the tests).  Raises RuntimeError when a decode fails."""
    modes = ("none",) + KNOCKOUTS
    frames = 0 if frame is None else frame + 1
    fsz = 2 * (w * h + (2 * (w // 2) * (h // 2) if chroma == "420" else 0))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        procs = {m: _oracle(stream, tmp / f"oracle_{m}.yuv", m, frames)
                 for m in modes}
        try:
            data = stream.read_bytes()
            for m in modes:
                port_decode(data, tmp / f"port_{m}.yuv",
                            _KnockedOut(device, m, port_hook), frames)
            for m, p in procs.items():
                _, err = p.communicate()
                if p.returncode != 0:
                    raise RuntimeError(f"the oracle's decode under {m} "
                                       f"failed: rc {p.returncode}\n"
                                       f"{err[-2000:]}")
                a = (tmp / f"port_{m}.yuv").read_bytes()
                b = (tmp / f"oracle_{m}.yuv").read_bytes()
                if frame is not None:
                    a, b = (x[frame * fsz:(frame + 1) * fsz] for x in (a, b))
                d = first_diffs(a, b, w, h, chroma)
                if frame is not None and d["frame"] is not None:
                    d["frame"] += frame
                out[m] = d
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                p.communicate()
    return out


def first_agreeing(diffs: dict):
    """The first of KNOCKOUTS under which the two decodes agree, or None."""
    return next((m for m in KNOCKOUTS if diffs[m]["equal"]), None)


def format_stages(diffs: dict, b_name: str = "numpy") -> str:
    """The report of `stage_diffs` as text: a line a mode, then the first
    knock-out under which the decodes agree."""
    lines = []
    for m, d in diffs.items():
        if d["equal"]:
            lines.append(f"{m:7s} agree ({d['frames'][0]} frames)")
            continue
        if not d["planes"]:
            lines.append(f"{m:7s} differ: {d['frames'][0]} frames (port), "
                         f"{d['frames'][1]} ({b_name})")
            continue
        p = d["planes"][0]
        lines.append(f"{m:7s} differ: frame {d['frame']} plane {p['plane']} "
                     f"first at {p['first'][0]} {p['first'][1]} port={p['a']}"
                     f" {b_name}={p['b']} ({p['count']} diffs in the plane)")
    first = first_agreeing(diffs)
    lines.append("the decodes agree without a knock-out"
                 if diffs["none"]["equal"] else
                 f"first knock-out under which they agree: {first}"
                 if first else "they differ under every knock-out: the "
                 "difference is before the deblock")
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
    ap.add_argument("--stages", action="store_true",
                    help="bisect to a deblock stage: the port and the "
                    "oracle under each knock-out")
    ap.add_argument("--frame", type=int, help="with --stages: compare "
                    "output frame N alone (both decode N + 1 frames)")
    a = ap.parse_args(argv)
    if a.stages:
        if a.ref is not None:
            ap.error("--stages decodes the oracle under each knock-out: "
                     "no --ref")
        d = stage_diffs(a.stream, a.w, a.h, a.device, a.frame, a.chroma)
        print(format_stages(d))
        return 0 if d["none"]["equal"] else 1
    if a.frame is not None:
        ap.error("--frame goes with --stages")
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
