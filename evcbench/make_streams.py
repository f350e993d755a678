"""Make a configuration's GOP streams anew, on any host (no card).  No run
of the benchmark imports this: it imports the repo's seeded encoder,
tools/evc_enc.py, which imports `xevd_tpu`.

    python -m evcbench.make_streams CONFIG_FILE

encodes each GOP of the configuration (`gops`: tools/evc_enc
`encode_stream` arguments, in the order `encode_stream_order` names) into
evcbench/<streams>_<g>.evc beside the configuration's `streams` path, one
worker process a GOP, and writes <streams>.json: the specs, every
picture's MD5 by the reference decoder (`reference.py`), and the seconds
each encode took.  Then `python -m evcbench.make_reference` writes the
reference file a run compares with.

The configuration's streams were made by this script (gop1080_base:
341-378 s of one core a GOP of five 1080p pictures, `encoder_s` in
streams/gop1080.json), and their MD5s by the reference decoder, which is
the frozen copy of the code that the port's host half was copied from:
no normative decoder's output is in the repo.  The test streams
(evcbench/tests/data/tiny*.evc) were made by this script from their
configuration files there."""
from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import sys
import time
from pathlib import Path

from . import reference as R
from .captures import stream_paths
from .spec import ROOT, load_json


def _encode(spec: list, out: str) -> float:
    sys.path.insert(0, str(ROOT / "tools"))
    sys.path.insert(0, str(ROOT))
    import evc_enc
    w, h, n, qp, seed, gop, density, bd, profile, tools, intra_frac = spec
    t0 = time.perf_counter()
    data = evc_enc.encode_stream(
        w, h, n, qp, seed, gop, density, bd=bd, profile=profile,
        tools=evc_enc.Tools(**{k: 1 for k in tools}), intra_frac=intra_frac)
    Path(out).write_bytes(data)
    return time.perf_counter() - t0


def _md5s(path: str) -> list:
    return [R.picture_md5(p, bd) for p, bd in
            R.decode(Path(path).read_bytes())]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    config = load_json(Path(argv[0]))
    paths = [str(p) for p in stream_paths(config)]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(mp_context=ctx) as pool:
        seconds = list(pool.map(_encode, config["gops"], paths))
        md5s = list(pool.map(_md5s, paths))
    out = Path(paths[0]).with_name(f"{Path(config['streams']).name}.json")
    out.write_text(json.dumps({"spec": config["gops"], "md5s": md5s,
                               "encoder_s": seconds}, indent=1) + "\n")
    print(f"wrote {len(paths)} streams and {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
