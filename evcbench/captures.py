"""The host half of a GOP job: the port's capture of each GOP (parse,
entropy decode, derive and pack, `xevd_tpu_torch.parallel.gop`
`_capture_gop`, which also decodes every picture with the numpy backend
for the entry's own check), in worker processes, one GOP a worker.

`Workers` is a pool of such processes, started and warmed in set-up: each
imports the port with no CUDA device visible (the card is the run's
alone), loads the host engine's library and runs one thread.  A window's
job hands the workers its GOPs' stream bytes and waits for every capture
(`Workers.capture`): the host half is timed inside the job.

Set-up's warm-up jobs read the configuration's captures from a cache,
build/evcbench/captures/<configuration>/<digest>/ inside the checkout
(git-ignored, a fixed path); <digest> hashes the port's sources, the host
engine's C sources and the configuration's streams, so a checkout whose
program differs captures anew, and a run reads only its own
configuration's captures.  The first run of a checkout makes them with
the same workers."""
from __future__ import annotations

import hashlib
import multiprocessing
import os
import pickle
import time
from pathlib import Path

from .spec import HERE, ROOT

CACHE = ROOT / "build" / "evcbench" / "captures"
ONE_THREAD = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def stream_paths(config: dict) -> list[Path]:
    """The configuration's GOP streams, evcbench/streams/<streams>_<g>.evc."""
    return [HERE / "streams" / f"{config['streams']}_{g}.evc"
            for g in range(len(config["gops"]))]


def digest(config: dict, root: Path = ROOT) -> str:
    h = hashlib.sha1()
    pkg = root / "xevd_tpu_torch"
    sources = sorted([*pkg.rglob("*.py"), *pkg.rglob("*.c"),
                      *(root / "native").glob("*.[ch]")])
    for p in sources + stream_paths(config):
        h.update(p.relative_to(root).as_posix().encode() + b"\0")
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _init(barrier):
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    for k in ONE_THREAD:
        os.environ[k] = "1"
    import torch
    torch.set_num_threads(1)
    from xevd_tpu_torch.host import native
    from xevd_tpu_torch.parallel import gop  # noqa: F401
    native.get_lib()
    barrier.wait()


def _capture(data: bytes) -> tuple:
    from xevd_tpu_torch.parallel.gop import _capture_gop
    t0 = time.perf_counter()
    cap = _capture_gop(data)
    return time.perf_counter() - t0, cap


class Workers:
    """`n` capture processes (spawned, so that none shares the parent's
    CUDA state); a context manager that stops and waits for every one.
    They start at once; `ready()` waits until each has imported the port
    and loaded the host engine, so the parent's own set-up runs
    meanwhile."""

    def __init__(self, n: int):
        ctx = multiprocessing.get_context("spawn")
        self.n = n
        self._barrier = ctx.Barrier(n + 1)
        self.seconds = []        # each GOP's capture in its worker, last job
        self.pool = ctx.Pool(n, initializer=_init, initargs=(self._barrier,))

    def ready(self) -> "Workers":
        if self._barrier is not None:
            self._barrier.wait(timeout=300)
            self._barrier = None
        return self

    def capture(self, streams: list[bytes]) -> list:
        """The captures of `streams` (one GOP each), in their order."""
        self.ready()
        pending = [self.pool.apply_async(_capture, (s,)) for s in streams]
        got = [p.get() for p in pending]
        self.seconds = [s for s, _ in got]
        return [cap for _, cap in got]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None and self._barrier is None:
            self.pool.close()
        else:
            self.pool.terminate()
        self.pool.join()


def load(config: dict, workers: Workers, cache: Path = CACHE
         ) -> tuple[list, dict]:
    """([captures of GOP g], {"cold": GOPs captured now, "capture_s": the
    workers' wall, "load_s": reading the cache}).  Captures the missing
    GOPs first, with `workers`."""
    streams = stream_paths(config)
    where = cache / config["name"] / digest(config)
    pkls = [where / f"g{g}.pkl" for g in range(len(streams))]
    missing = [(e, p) for e, p in zip(streams, pkls) if not p.exists()]
    t0 = time.perf_counter()
    if missing:
        where.mkdir(parents=True, exist_ok=True)
        got = workers.capture([e.read_bytes() for e, _ in missing])
        for (_, p), cap in zip(missing, got):
            tmp = p.with_suffix(".tmp")
            tmp.write_bytes(pickle.dumps(cap, pickle.HIGHEST_PROTOCOL))
            tmp.replace(p)
    t1 = time.perf_counter()
    # the pickles are the program's own captures, made in this checkout
    caps = [pickle.loads(p.read_bytes()) for p in pkls]
    return caps, {"cold": len(missing), "capture_s": t1 - t0,
                  "load_s": time.perf_counter() - t1}
