"""Reference worker of chip_smoke.py, run as a program of its own:

    python tests/torch_reference.py SPEC OUT_EVC OUT_YUV

SPEC is a JSON list (w, h, frames, qp, seed, gop, density, bit depth,
profile, tools, intra_frac) of `tools/evc_enc.encode_stream`.  The worker
writes the stream to OUT_EVC (kept when it exists: the stream is a
function of SPEC) and decodes it with `xevd_tpu`'s CLI on the numpy oracle
backend (NumpyPixelBackend, golden-tested against the reference decoder)
to 10-bit YUV in OUT_YUV.  Its last line of output is one JSON object
{"frames", "gen_s", "numpy_s"}.

It runs as a separate program so that chip_smoke.py, the program under
test, imports nothing of `xevd_tpu`: the oracle stays independent of the
port's copy of the host code and serves as a reference decoder binary
would.  It needs no JAX."""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv) -> int:
    spec, evc, yuv = json.loads(argv[0]), Path(argv[1]), Path(argv[2])
    w, h, n, qp, seed, gop, density, bd, profile, tools, intra_frac = spec
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
    t0 = time.perf_counter()
    if not evc.exists():
        import evc_enc
        data = evc_enc.encode_stream(
            w, h, n, qp, seed, gop, density, bd=bd, profile=profile,
            tools=evc_enc.Tools(**{k: 1 for k in tools}),
            intra_frac=intra_frac)
        evc.parent.mkdir(parents=True, exist_ok=True)
        tmp = evc.with_suffix(".tmp")
        tmp.write_bytes(data)
        tmp.replace(evc)
    t_gen = time.perf_counter() - t0
    from xevd_tpu.app import main as xevd_main
    t0 = time.perf_counter()
    rc = xevd_main(["-i", str(evc), "-o", str(yuv), "--output-bit-depth",
                    "10", "-v", "0", "--backend", "numpy"])
    t_np = time.perf_counter() - t0
    if rc != 0:
        print(f"numpy oracle decode failed: rc {rc}", file=sys.stderr)
        return 1
    frames = yuv.stat().st_size // (w * h * 3)    # 4:2:0, 2 bytes a sample
    print(json.dumps({"frames": frames, "gen_s": t_gen, "numpy_s": t_np}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
