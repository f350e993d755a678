#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (xevd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), torch/CUDA versions
   and which entropy engine runs; exits non-zero without a CUDA device.
2. Builds the CUDA kernels from xevd_tpu_torch/csrc with nvcc (sm_90a).
3. Kernel phases: every hand-written kernel against its plain PyTorch
   version on the card, on numpy-seeded inputs at the shapes of the 1080p
   main path, with exact equality (integer kernels, tolerance 0), and
   both times; the intra scan on CIF with random CU lists, then on the
   1080p stream's own frames (step 4).
4. Slice phase: a 1920x1080 two-frame Baseline all-intra stream and a
   352x288 four-frame 10-bit one (tools/evc_enc, seeded) are decoded with
   Decoder(backend=TorchPixelBackend("cuda")) and with the numpy oracle
   backend; the 10-bit YUV bytes must be equal.  The intra scan kernel is
   held to its plain version on every 1080p frame's own CU table and
   planes.  Launch counters are reset just before the counted 1080p
   decode and must all be > 0 after it.  The counted decode runs three
   times; each prints its frames/s and per-stage CUDA-event times.
5. Prints {"kernels": [...]} and, as the last line,
   {"ok": true, "device": {...}}.

Any failure raises and the exit code is non-zero.  Imports no JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "smoke"          # gitignored
STREAM_DIR = REPO / "tests" / "fixtures"  # gitignored stream cache
TIMED_RUNS = 3

# name -> (route, source, TPU-side function it replaces)
KERNELS = {
    "itdq": ("cuda", "xevd_tpu_torch/csrc/itdq.cu",
             "xevd_tpu/ops/jax_itdq.py:47"),
    "recon": ("triton", "xevd_tpu_torch/ops/recon_triton.py",
              "xevd_tpu/ops/pipeline.py:221"),
    "pad": ("triton", "xevd_tpu_torch/ops/recon_triton.py",
            "xevd_tpu/ops/pipeline.py:241"),
    "intra_scan": ("cuda", "xevd_tpu_torch/csrc/intra.cu",
                   "xevd_tpu/ops/jax_intra.py:113"),
    "deblock_luma_ver": ("cuda", "xevd_tpu_torch/csrc/deblock.cu",
                         "xevd_tpu/ops/jax_deblock.py:60"),
    "deblock_luma_hor": ("cuda", "xevd_tpu_torch/csrc/deblock.cu",
                         "xevd_tpu/ops/jax_deblock.py:78"),
    "deblock_chroma_ver": ("cuda", "xevd_tpu_torch/csrc/deblock.cu",
                           "xevd_tpu/ops/jax_deblock.py:96"),
    "deblock_chroma_hor": ("cuda", "xevd_tpu_torch/csrc/deblock.cu",
                           "xevd_tpu/ops/jax_deblock.py:170"),
}


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def timed(torch, fn, reps):
    """Mean milliseconds of fn() over `reps` runs after one warm-up, by
    CUDA events on the current stream."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def run_case(torch, case, results, reps, plain_reps, main=False):
    """Holds one kernel against its plain version (exact) and times both:
    `reps` kernel runs, `plain_reps` plain runs (0: the timed comparison
    run itself, for a plain version too slow to run twice).  `main` marks
    the case at the main path's shapes, whose times the summary reports."""
    from tests.torch_helpers import max_abs_err
    got = case.kernel()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    want = case.plain()
    t1.record()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{case.name} {case.shape}: kernel != plain "
                             f"(max abs err {err})")
    ms = timed(torch, case.kernel, reps) if reps else None
    plain_ms = (timed(torch, case.plain, plain_reps) if plain_reps
                else t0.elapsed_time(t1))
    r = results.setdefault(case.name, {"max_abs_err": 0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    if main:
        r.update(ms=ms, plain_ms=plain_ms, shape=case.shape)
    timing = (f"kernel {ms:9.4f} ms  plain {plain_ms:10.4f} ms" if reps
              else "")
    log(f"  {case.name:20s} {case.shape:34s} equal  {timing}"
        f"{'  (main path)' if main else ''}")


# --------------------------------------------------------------------------
# kernel phases
# --------------------------------------------------------------------------
def kernel_phases(torch, dev, results):
    """Every kernel against its plain version on numpy-seeded inputs at the
    1080p main path's shapes; the intra scan here on CIF with random CU
    lists and masks (slice_phase holds it to its plain version on the 1080p
    stream's own frames)."""
    from tests.torch_helpers import (deblock_case, intra_case, itdq_case,
                                     itdq_size_case, pad_case, recon_case)
    from xevd_tpu_torch.ops.tables import BORDER, PAD_C, PAD_L, PAD_R

    H, W = 1088, 1920                     # 1080p, CTU-padded
    log("phase itdq")
    for bd in (8, 10):
        for lg in range(2, 7):
            run_case(torch, itdq_size_case(dev, bd, lg), results, 0, 0)
        run_case(torch, itdq_case(dev, bd, H, W, seed=100), results, 10, 2,
                 main=bd == 8)

    log("phase recon/pad")
    for bd in (8, 10):
        run_case(torch, recon_case(dev, bd, BORDER + H + PAD_R,
                                   BORDER + W + PAD_R, seed=200),
                 results, 50, 50, main=bd == 8)
        run_case(torch, pad_case(dev, bd, 1080, 1920, PAD_L, seed=210),
                 results, 50, 50, main=bd == 8)
        run_case(torch, pad_case(dev, bd, 540, 960, PAD_C, seed=220),
                 results, 50, 50)

    log("phase intra_scan (CIF, random CU lists)")
    for bd in (8, 10):
        for chroma in (True, False):
            run_case(torch, intra_case(dev, 288, 352, bd, chroma,
                                       seed=300 + bd), results, 10, 1)

    log("phase deblock")
    for bd in (8, 10):
        for kind in ("luma_ver", "luma_hor", "chroma_ver", "chroma_hor"):
            run_case(torch, deblock_case(dev, kind, bd, 270, 480, seed=400),
                     results, 20, 3, main=bd == 8)


def intra_main_path(torch, dev, packed, results):
    """The intra scan kernel against its plain version on the 1080p
    stream's own frames: the CU tables, residual and picture planes that
    the main path hands the kernel."""
    from tests.torch_helpers import intra_planes_case
    from xevd_tpu_torch.ops import pack as PK
    from xevd_tpu_torch.ops.itdq import itdq
    from xevd_tpu_torch.ops.recon import recon
    from xevd_tpu_torch.ops.tables import device_tables

    log("phase intra_scan (1080p stream frames)")
    tab = device_tables(dev)
    for i, pf in enumerate(packed):
        df = PK.upload(pf, dev)
        resids = itdq((df.coef_y, df.coef_u, df.coef_v), df.tus, pf.shp_y,
                      pf.shp_c, pf.bd, tab)
        recs = [None if r is None else recon(r, pf.bd) for r in resids]
        shape = (f"1080p frame {i}, {df.icu.shape[0]} CUs, "
                 f"{pf.shp_y[0]}x{pf.shp_y[1]}")
        run_case(torch, intra_planes_case(dev, recs, resids, df.icu, pf.bd,
                                          pf.chroma, shape),
                 results, 5, 0, main=i == 0)


# --------------------------------------------------------------------------
# slice phase
# --------------------------------------------------------------------------
def make_stream(name, w, h, n, qp, seed, gop, density=0.5, bd=8) -> Path:
    path = STREAM_DIR / f"torch_smoke_{name}.evc"
    if not path.exists():
        sys.path.insert(0, str(REPO / "tools"))
        import evc_enc
        t0 = time.perf_counter()
        data = evc_enc.encode_stream(w, h, n, qp, seed, gop, density, bd=bd)
        STREAM_DIR.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
        log(f"  generated {path.name}: {w}x{h} x{n} bd{bd}, {len(data)} B "
            f"in {time.perf_counter() - t0:.1f} s")
    return path


def decode_to_yuv(data: bytes, backend, out: Path) -> int:
    """Decode a length-prefixed NALU stream and write 10-bit YUV; returns
    the number of frames written."""
    from xevd_tpu import NAL_UNIT_LENGTH_BYTE, Decoder, info
    from xevd_tpu.utils.yuv import YuvWriter

    dec = Decoder(backend=backend)
    pos, writer, n = 0, None, 0
    frames = []
    while pos + NAL_UNIT_LENGTH_BYTE <= len(data):
        ln, _, _ = info(data[pos:pos + 6])
        stat = dec.decode(data[pos + 4:pos + 4 + ln])
        pos += 4 + ln
        if stat.fnum >= 0:
            f, _ = dec.pull()
            if f is not None:
                frames.append(f)
    while True:
        f, _ = dec.pull()
        if f is None:
            break
        frames.append(f)
    for f in frames:
        if writer is None:
            writer = YuvWriter(str(out), f.y.shape[1], f.y.shape[0], 10,
                               f.chroma_format_idc)
        writer.write(f)
        n += 1
    if writer:
        writer.close()
    return n


def slice_phase(torch, dev, K, results):
    from xevd_tpu.decoder import NumpyPixelBackend
    from xevd_tpu_torch import TorchPixelBackend
    from xevd_tpu_torch.app import main as app_main
    from xevd_tpu_torch.ops.pipeline import STAGES

    class KeepingBackend(TorchPixelBackend):
        """Keeps each frame's host payload, to replay its intra scan."""

        def __init__(self, device):
            super().__init__(device=device)
            self.packed = []

        def pack_frame(self, job, sps, refp=None):
            pf = super().pack_frame(job, sps, refp)
            self.packed.append(pf)
            return pf

    WORK.mkdir(parents=True, exist_ok=True)
    log("phase slice: streams")
    s1080 = make_stream("1080p_i", 1920, 1080, 2, 32, 777, "I", 0.3)
    scif = make_stream("cif10_i", 352, 288, 4, 32, 778, "I", 0.5, bd=10)

    packed = {}
    for name, path, nfr in (("cif10", scif, 4), ("1080p", s1080, 2)):
        data = path.read_bytes()
        t0 = time.perf_counter()
        n_np = decode_to_yuv(data, NumpyPixelBackend(), WORK / f"{name}_np.yuv")
        t_np = time.perf_counter() - t0
        t0 = time.perf_counter()
        backend = KeepingBackend(dev)
        n_t = decode_to_yuv(data, backend, WORK / f"{name}_t.yuv")
        packed[name] = backend.packed
        torch.cuda.synchronize()
        t_t = time.perf_counter() - t0
        a = (WORK / f"{name}_np.yuv").read_bytes()
        b = (WORK / f"{name}_t.yuv").read_bytes()
        if n_np != nfr or n_t != nfr or a != b:
            raise AssertionError(f"{name}: torch ({n_t} frames) != numpy "
                                 f"({n_np} frames), {len(a)} vs {len(b)} B")
        log(f"  {name}: {nfr} frames, 10-bit YUV equal to NumpyPixelBackend "
            f"({len(a)} B); numpy {t_np:.2f} s, torch first run {t_t:.2f} s")
    intra_main_path(torch, dev, packed["1080p"], results)

    # the port's CLI entry point on the CIF stream
    rc = app_main(["-i", str(scif), "-o", str(WORK / "cif10_app.yuv"),
                   "--output-bit-depth", "10", "--device", dev.type, "-v", "0"])
    if rc != 0 or (WORK / "cif10_app.yuv").read_bytes() != \
            (WORK / "cif10_np.yuv").read_bytes():
        raise AssertionError(f"xevd_tpu_torch.app: rc {rc} or output differs")
    log("  python -m xevd_tpu_torch.app --device cuda: CIF output equal")

    # the counted, timed main-path run: 1080p through Decoder + torch
    # backend, three times (the spread of the host clock)
    marks = []

    def on_stage(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev, time.perf_counter()))

    data = s1080.read_bytes()
    want = (WORK / "1080p_np.yuv").read_bytes()
    backend = TorchPixelBackend(device=dev, on_stage=on_stage)
    runs = []
    torch.cuda.synchronize()
    K.reset_counts()
    for rep in range(TIMED_RUNS):
        marks.clear()
        t0 = time.perf_counter()
        n = decode_to_yuv(data, backend, WORK / "1080p_t2.yuv")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if (WORK / "1080p_t2.yuv").read_bytes() != want:
            raise AssertionError("1080p timed run: output differs from numpy")
        stage_ms = {s: 0.0 for s in STAGES}
        for i, (name, ev, t) in enumerate(marks):
            if name == "start":
                continue
            _, prev_ev, prev_t = marks[i - 1]
            stage_ms[name] += ((t - prev_t) * 1e3 if name == "pack"
                               else prev_ev.elapsed_time(ev))
        stage_ms = {k: v / n for k, v in stage_ms.items()}
        device_ms = sum(v for k, v in stage_ms.items() if k != "pack")
        runs.append(n / wall)
        log(f"  1080p timed run {rep}: {n} frames in {wall:.4f} s = "
            f"{n / wall:.3f} frames/s (host entropy + pack + device + 10-bit "
            f"write); device stages {device_ms:.3f} of {wall * 1e3 / n:.3f} "
            f"ms a frame ({100 * device_ms * n / (wall * 1e3):.1f} %)")
        log("    per frame, ms (pack: host clock incl. copies; others: CUDA "
            "events between stage marks): " +
            ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()))
    counts = dict(K.launch_counts)
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing} ({counts})")
    log(f"  launch counts during the timed runs: {counts}")
    return counts, runs, stage_ms


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    log(gpu_line())
    sys.path.insert(0, str(REPO))
    from xevd_tpu import native
    from xevd_tpu_torch.kernels import build as K

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}, "
        f"native entropy engine: {native.available()}")
    K.build(verbose=True)      # always from this checkout's sources
    K.lib()
    log(f"build: nvcc {K.build_seconds:.1f} s "
        f"({', '.join(K.SOURCES)} -> {K.BUILD_DIR.relative_to(REPO)})")

    results = {}
    kernel_phases(torch, dev, results)
    counts, fps, stage_ms = slice_phase(torch, dev, K, results)

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = results[name]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"]})
    log(f"slice 1080p: frames/s {[round(f, 3) for f in fps]}; stage ms/frame "
        f"{json.dumps(stage_ms)}; total smoke time "
        f"{time.perf_counter() - t_start:.1f} s")
    log(gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
