"""Reference worker of chip_smoke.py, run as a program of its own:

    python tests/torch_reference.py SPEC OUT_EVC [OUT_YUV]
    python tests/torch_reference.py --streams SPECS OUT_DIR

SPEC is a JSON list (w, h, frames, qp, seed, gop, density, bit depth,
profile, tools, intra_frac) of `tools/evc_enc.encode_stream`.  The worker
writes the stream to OUT_EVC (kept when it exists: the stream is a
function of SPEC) and decodes it with `xevd_tpu`'s CLI on the numpy oracle
backend (NumpyPixelBackend, golden-tested against the reference decoder)
to 10-bit YUV in OUT_YUV; without OUT_YUV it only writes the stream.  Its
last line of output is one JSON object {"frames", "gen_s", "numpy_s"}
(frames and numpy_s null without a decode).  Before the decode it points
`xevd_tpu`'s native engine at the library the port builds for this host
(`tests/torch_helpers.py` `use_port_native_library`).

It runs as a separate program so that chip_smoke.py, the program under
test, imports nothing of `xevd_tpu`: the oracle stays independent of the
port's copy of the host code and serves as a reference decoder binary
would.  It needs no JAX.

With --streams, SPECS is a JSON list of SPECs: the worker writes stream i
to OUT_DIR/<i>.evc (kept when it exists), all in one process, and prints
{"streams", "gen_s"}.

    python tests/torch_reference.py --decode IN_EVC OUT_YUV
        [--knockout MODE] [--frames N]

decodes an existing stream with the numpy oracle to 10-bit YUV (the
oracle side of `python -m xevd_tpu_torch.diff`) and prints {"bytes",
"numpy_s"}: under knock-out MODE (`xevd_tpu_torch/knockout.py`,
applied to each frame's job by a wrapper of the oracle backend's
`decode_frame` in this process: the side of `--stages`), and the first N
output frames alone (0: all)."""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def write_stream(spec, evc: Path):
    """Encode SPEC into `evc` unless it exists."""
    if evc.exists():
        return
    w, h, n, qp, seed, gop, density, bd, profile, tools, intra_frac = spec
    import evc_enc
    data = evc_enc.encode_stream(
        w, h, n, qp, seed, gop, density, bd=bd, profile=profile,
        tools=evc_enc.Tools(**{k: 1 for k in tools}), intra_frac=intra_frac)
    evc.parent.mkdir(parents=True, exist_ok=True)
    tmp = evc.with_suffix(".tmp")
    tmp.write_bytes(data)
    tmp.replace(evc)


def use_port_native_library():
    """Point `xevd_tpu`'s native engine at the library the port builds for
    this host (xevd_tpu_torch/native_build.py; the same sources), before
    the JAX package's decoders run: `xevd_tpu.native` would load the
    committed native/libevc_entropy.so, built `-march=native` on another
    host, which dies with SIGILL on a CPU that lacks its instructions.
    Edits no file of `xevd_tpu`: only its module's library path.  Loads
    no torch (the port's host half alone)."""
    import xevd_tpu.native as XN
    from xevd_tpu_torch.host import native as PN
    PN.get_lib()         # this host's build, made here on first use
    if XN._SO != PN._SO:
        XN._SO, XN._LIB = PN._SO, None


def numpy_decode(evc: Path, yuv: Path, knockout="none", frames=0) -> float:
    """Decode `evc` with xevd_tpu's numpy oracle backend to 10-bit YUV in
    `yuv`, under `knockout` (`xevd_tpu_torch/knockout.py` `knock_out`) and
    the first `frames` output frames (0: all); returns the seconds it
    took.  The process loads no torch and none of the port's device
    code."""
    from xevd_tpu.app import main as xevd_main
    use_port_native_library()
    if knockout != "none":
        from xevd_tpu.decoder import NumpyPixelBackend
        from xevd_tpu_torch.knockout import knock_out
        decode_frame = NumpyPixelBackend.decode_frame

        def knocked_out(self, job, sps, refp):
            knock_out(job, knockout)
            return decode_frame(self, job, sps, refp)
        NumpyPixelBackend.decode_frame = knocked_out
    t0 = time.perf_counter()
    rc = xevd_main(["-i", str(evc), "-o", str(yuv), "--output-bit-depth",
                    "10", "-v", "0", "--backend", "numpy", "-f",
                    str(frames)])
    if rc != 0:
        raise RuntimeError(f"numpy oracle decode of {evc} failed: rc {rc}")
    return time.perf_counter() - t0


def main(argv) -> int:
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
    if argv[0] == "--decode":
        yuv = Path(argv[2])
        opts = dict(zip(argv[3::2], argv[4::2]))
        t_np = numpy_decode(Path(argv[1]), yuv,
                            opts.get("--knockout", "none"),
                            int(opts.get("--frames", 0)))
        print(json.dumps({"bytes": yuv.stat().st_size, "numpy_s": t_np}))
        return 0
    if argv[0] == "--streams":
        specs, out = json.loads(argv[1]), Path(argv[2])
        t0 = time.perf_counter()
        for i, spec in enumerate(specs):
            write_stream(spec, out / f"{i}.evc")
        print(json.dumps({"streams": len(specs),
                          "gen_s": time.perf_counter() - t0}))
        return 0
    spec, evc = json.loads(argv[0]), Path(argv[1])
    yuv = Path(argv[2]) if len(argv) > 2 else None
    w, h = spec[:2]
    t0 = time.perf_counter()
    write_stream(spec, evc)
    t_gen = time.perf_counter() - t0
    if yuv is None:
        print(json.dumps({"frames": None, "gen_s": t_gen, "numpy_s": None}))
        return 0
    t_np = numpy_decode(evc, yuv)
    frames = yuv.stat().st_size // (w * h * 3)    # 4:2:0, 2 bytes a sample
    print(json.dumps({"frames": frames, "gen_s": t_gen, "numpy_s": t_np}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
