"""The JAX package's answers for the port's gate streams, stored in
tests/torch_jax_reference.json, so that the CPU tests hold the port to
them without compiling the JAX backend again.

    python -m tests.torch_jax_reference --update

remakes every entry of the file from its spec alone, one process an
entry and one a core at a time, and rewrites the file.  A new gate case
is added to the file as {"case", "spec"} and `--update` fills in its
answer; a changed case changes its spec there.

Two kinds of entry:

- "streams": one stream, its `spec` the arguments of
  `tests/conftest.py` `make_stream` (less the path); its answer, `md5s`,
  is the per-frame MD5s of the 10-bit YUV that `python -m xevd_tpu.app
  --backend jax --output-bit-depth 10` writes, keyed by the SHA-256 of
  the stream's bytes and that output bit depth (`out_bd`);
- "gops": independent GOP streams, its `spec` the `mesh` size and either
  `gen_gop_streams` (the arguments of `xevd_tpu.parallel.gop`'s
  generator) or `streams` (a `make_stream` spec a GOP); its answer is
  `decode_gops_sharded`'s (`dev`, `ser`) on `make_mesh(mesh)`, keyed by
  the SHA-256 of the streams in order and the mesh size.

The file's `code_digest` hashes the code that made the answers: the
JAX package's sources and the native engine's (`native/*.c`, `*.h`,
which `use_port_native_library` builds for the decode).  An answer is
used only when the file's digest is the tree's and its key is the
stream's; otherwise the JAX package decodes live, as a test did before
the store, and a `StoreMiss` warning names the case, so a missing entry
costs time and never loses the check."""
from __future__ import annotations

import argparse
import concurrent.futures
import functools
import hashlib
import json
import multiprocessing
import os
import sys
import tempfile
import warnings
from pathlib import Path

from xevd_tpu_torch.bench import yuv_md5s

REPO = Path(__file__).resolve().parent.parent
STORE = Path(__file__).with_suffix(".json")
OUT_BD = 10


class StoreMiss(UserWarning):
    """A JAX answer the store does not hold: the case was decoded live."""


def code_digest() -> str:
    """SHA-256 of the JAX package's sources and the native engine's."""
    h = hashlib.sha256()
    for p in sorted([*(REPO / "xevd_tpu").rglob("*.py"),
                     *(REPO / "native").glob("*.[ch]")]):
        data = p.read_bytes()
        h.update(f"{p.relative_to(REPO).as_posix()}\0{len(data)}\0".encode())
        h.update(data)
    return h.hexdigest()


def gops_sha256(streams: list[bytes]) -> str:
    """SHA-256 of the GOP streams in order (of their SHA-256 digests)."""
    h = hashlib.sha256()
    for s in streams:
        h.update(hashlib.sha256(s).digest())
    return h.hexdigest()


@functools.cache
def _store() -> dict:
    """{key: stored answer} of the file, empty when its code digest is not
    this tree's (every lookup then misses)."""
    doc = json.loads(STORE.read_text())
    if doc["code_digest"] != code_digest():
        return {}
    out = {}
    for e in doc["streams"]:
        if "md5s" in e:
            out[(e["sha256"], e["out_bd"])] = e["md5s"]
    for e in doc["gops"]:
        if "dev" in e:
            out[(e["sha256"], e["spec"]["mesh"])] = (e["dev"], e["ser"])
    return out


def _miss(case: str, key: tuple):
    warnings.warn(StoreMiss(
        f"{case}: no stored JAX answer for {key} in {STORE.name} (its code "
        "digest or the stream differs); decoded live.  Give the case its "
        "spec there and run `python -m tests.torch_jax_reference "
        "--update`"), stacklevel=3)


def decode_jax(data: bytes, w: int, h: int) -> list[str]:
    """The JAX backend's per-frame MD5s of `data`, decoded live by
    `xevd_tpu`'s CLI to 10-bit YUV."""
    from tests.torch_reference import use_port_native_library
    from xevd_tpu.app import main
    use_port_native_library()
    with tempfile.TemporaryDirectory() as d:
        evc, yuv = Path(d) / "s.evc", Path(d) / "s.yuv"
        evc.write_bytes(data)
        rc = main(["-i", str(evc), "-o", str(yuv), "-v", "0", "--backend",
                   "jax", "--output-bit-depth", str(OUT_BD)])
        if rc != 0:
            raise RuntimeError(f"the JAX backend's decode failed: rc {rc}")
        return yuv_md5s(yuv.read_bytes(), w, h)


def decode_gops_jax(streams: list[bytes], mesh: int) -> tuple[list, list]:
    """`xevd_tpu.parallel.gop.decode_gops_sharded` of `streams` on the
    first `mesh` JAX devices, live."""
    from tests.torch_reference import use_port_native_library
    from xevd_tpu.parallel import gop as JG
    use_port_native_library()
    return JG.decode_gops_sharded(streams, mesh=JG.make_mesh(mesh))


def jax_md5s(data: bytes, w: int, h: int, case: str) -> list[str]:
    """The JAX backend's per-frame 10-bit MD5s of the w x h stream `data`:
    the stored answer, or on a miss the live decode and a warning that
    names `case`."""
    key = (hashlib.sha256(data).hexdigest(), OUT_BD)
    md5s = _store().get(key)
    if md5s is None:
        _miss(case, key)
        md5s = decode_jax(data, w, h)
    return md5s


def assert_equals_jax(yuv: bytes, data: bytes, w: int, h: int, case: str):
    """The port's 10-bit YUV `yuv` of stream `data` equals the JAX
    backend's decode frame by frame (MD5s); names the first frame that
    differs."""
    want = jax_md5s(data, w, h, case)
    got = yuv_md5s(yuv, w, h)
    assert len(got) == len(want), \
        f"{case}: {len(got)} frames written, JAX wrote {len(want)}"
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert not bad, f"{case}: frame {bad[0]} differs from JAX's " \
        f"(frames {bad})"


def jax_gop_md5s(streams: list[bytes], mesh: int, case: str):
    """JAX's `decode_gops_sharded` (device MD5s, serial MD5s) of the GOP
    `streams` on a mesh of `mesh` devices: stored, or on a miss live with
    a warning that names `case`."""
    key = (gops_sha256(streams), mesh)
    got = _store().get(key)
    if got is None:
        _miss(case, key)
        got = decode_gops_jax(streams, mesh)
    return got


# --- remaking the answers from the specs ----------------------------------

def make_streams(spec: dict) -> list[bytes]:
    """The stream (a one-item list) of a "streams" spec, or the GOP
    streams of a "gops" spec."""
    from tests.conftest import make_stream
    if "gen_gop_streams" in spec:
        from xevd_tpu.parallel import gop as JG
        return JG.gen_gop_streams(**spec["gen_gop_streams"])
    out = []
    with tempfile.TemporaryDirectory() as d:
        for i, s in enumerate(spec.get("streams", [spec])):
            out.append(make_stream(Path(d) / f"{i}.evc", **s).read_bytes())
    return out


def derive(kind: str, entry: dict) -> dict:
    """`entry` with its key and answer remade from its spec by the JAX
    package (run in a process of its own: tests/conftest.py's JAX set-up,
    the CPU platform with 8 devices, is made on import)."""
    import tests.conftest  # noqa: F401
    spec = entry["spec"]
    streams = make_streams(spec)
    if kind == "streams":
        md5s = decode_jax(streams[0], spec["w"], spec["h"])
        return {"case": entry["case"], "spec": spec, "out_bd": OUT_BD,
                "sha256": hashlib.sha256(streams[0]).hexdigest(),
                "md5s": md5s}
    dev, ser = decode_gops_jax(streams, spec["mesh"])
    return {"case": entry["case"], "spec": spec,
            "sha256": gops_sha256(streams), "dev": dev, "ser": ser}


def derive_all(doc: dict) -> dict:
    """The store `doc` remade from its specs under this tree's code
    digest: every entry derived in a fresh spawned process, one a core
    at a time."""
    todo = [(kind, e) for kind in ("streams", "gops") for e in doc[kind]]
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(len(todo), os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn"),
            max_tasks_per_child=1) as pool:
        futs = [pool.submit(derive, kind, e) for kind, e in todo]
        done = [f.result() for f in futs]
    out = {"code_digest": code_digest(), "streams": [], "gops": []}
    for (kind, _), e in zip(todo, done):
        out[kind].append(e)
    return out


def write(doc: dict):
    """Write the store `doc`, an entry a line."""
    parts = [f'{{"code_digest": {json.dumps(doc["code_digest"])}']
    for kind in ("streams", "gops"):
        rows = ",\n  ".join(json.dumps(e) for e in doc[kind])
        parts.append(f'"{kind}": [\n  {rows}\n ]')
    tmp = STORE.with_suffix(".tmp")
    tmp.write_text(",\n ".join(parts) + "}\n")
    tmp.replace(STORE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--update", action="store_true", required=True,
                    help="remake every entry from its spec and rewrite "
                    "the file")
    ap.parse_args(argv)
    write(derive_all(json.loads(STORE.read_text())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
