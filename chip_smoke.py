#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (xevd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), torch/CUDA versions
   and which entropy engine runs; exits non-zero without a CUDA device.
   Starts, in worker processes, the generation of the six test streams
   (tools/evc_enc, seeded) and their decodes by the numpy oracle backend.
2. Builds the CUDA kernels from xevd_tpu_torch/csrc with nvcc (sm_90a).
3. Kernel phases: every hand-written kernel against its plain PyTorch
   version on the card, on numpy-seeded inputs at the shapes of the 1080p
   main paths, with exact equality (integer kernels, tolerance 0), and
   both times: ITDQ Baseline, Main iqt and every ATS basis pair; MC with
   the Baseline and the Main taps at every (plane, case, bit depth) and on
   a synthetic 1080p frame; recon, pad, deblock; the Baseline intra scan
   and the EIPD wavefront scan with HTDF on CIF with random CU lists
   (step 4 holds the scans and MC to their plain versions on the streams'
   own frames).
4. Slice phase: six streams are decoded with Decoder(backend=
   TorchPixelBackend("cuda")); each 10-bit YUV must equal the numpy
   backend's: 1920x1080 Baseline all-intra (2 frames), 352x288 10-bit
   all-intra (4), 1920x1080 Baseline IPPP (4: bench.py's config-2 stream
   cut from 16 frames), 352x288 10-bit RA (5, bi-prediction), 1920x1080
   Main RA (5 pictures: bench.py's config-3 stream cut from 9 frames to 3
   and from 14 tools to the 11 without SUCO, ADDB and ALF) and 352x288
   10-bit Main IPPP with DRA, iqt, ATS and HTDF (4).  The Baseline intra
   scan kernel is held to its plain version on every 1080p intra frame's
   own CU table and planes, the MC kernel on every 1080p P frame's own
   block table and on the Main stream's B pictures (Main taps), the EIPD
   scan kernel on the Main stream's I picture and one B picture.  The CLI
   entry point decodes the CIF RA and the CIF Main streams.  Three main
   paths are counted and timed: the 1080p all-intra decode once, the
   1080p IPPP decode twice and the 1080p Main RA decode three times; the
   launch counters are reset just before each path and read just after
   it, and every kernel of the path must have launched.  Each counted
   decode prints its frames/s and per-stage CUDA-event times.
5. Prints {"kernels": [...]} (launches from the Main RA path; the
   Baseline intra scan's from the IPPP path) and, as the last line,
   {"ok": true, "device": {...}}.

Any failure raises and the exit code is non-zero.  Imports no JAX.
"""
from __future__ import annotations

import json
import multiprocessing
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "smoke"          # gitignored
STREAM_DIR = REPO / "tests" / "fixtures"  # gitignored stream cache
TIMED_RUNS = 3          # of the Main path
TIMED_RUNS_BASELINE = 2  # of the 1080p IPPP path
# bench.py's config-3 tools without SUCO, ADDB and ALF (not ported)
MAIN_TOOLS = ("eipd", "cm_init", "btt", "adcc", "admvp", "hmvp", "mmvd",
              "amvr", "iqt", "ats", "htdf")
# name -> tools/evc_enc.encode_stream arguments (w, h, frames, qp, seed,
# gop, density, bd, profile, tools, intra_frac)
STREAMS = {
    "1080p_main_ra": (1920, 1080, 3, 32, 779, "RA", 0.3, 8, 1, MAIN_TOOLS,
                      0.1),
    "1080p_p": (1920, 1080, 4, 32, 777, "IPPP", 0.3, 8, 0, (), 0.35),
    "1080p_i": (1920, 1080, 2, 32, 777, "I", 0.3, 8, 0, (), 0.35),
    "cif10_main_p": (352, 288, 4, 30, 802, "IPPP", 0.5, 10, 1,
                     ("dra", "eipd", "cm_init", "admvp", "hmvp", "iqt", "ats",
                      "htdf"), 0.35),
    "cif10_i": (352, 288, 4, 32, 778, "I", 0.5, 10, 0, (), 0.35),
    "cif10_ra": (352, 288, 5, 32, 779, "RA", 0.5, 10, 0, (), 0.35),
}
# frames each stream decodes to (RA rounds up to a whole GOP)
FRAMES = {"1080p_main_ra": 5}

# name -> (route, source, TPU-side function it replaces)
KERNELS = {
    "itdq": ("cuda", "xevd_tpu_torch/csrc/itdq.cu",
             "xevd_tpu/ops/jax_itdq.py:47"),
    "intra_scan_wave": ("cuda", "xevd_tpu_torch/csrc/intra_main.cu",
                        "xevd_tpu/ops/jax_intra_main.py:572"),
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
    "mc": ("cuda", "xevd_tpu_torch/csrc/mc.cu",
           "xevd_tpu/ops/jax_mc.py:50"),
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
    1080p main paths' shapes; the two intra scans here on CIF with random
    CU lists and masks, MC on a synthetic 1080p inter frame and on small
    tables of every (taps, plane, case, bit depth) (slice_phase holds the
    scans and MC to their plain versions on the 1080p streams' own
    frames)."""
    from tests.torch_helpers import (deblock_case, intra_case, intra_wave_case,
                                     itdq_case, itdq_size_case, mc_case,
                                     mc_size_case, pad_case, recon_case,
                                     recon_pred_case)
    from xevd_tpu_torch.ops.tables import BORDER, PAD_C, PAD_L, PAD_R

    H, W = 1088, 1920                     # 1080p, CTU-padded
    log("phase itdq (Baseline DCT-2; Main iqt DCT-2 and ATS bases)")
    for bd in (8, 10):
        for lg in range(2, 7):
            run_case(torch, itdq_size_case(dev, bd, lg), results, 0, 0)
            for trs in ((0, 5, 6, 9, 10) if lg <= 5 else (0,)):
                run_case(torch, itdq_size_case(dev, bd, lg, iqt=True,
                                               trs=trs), results, 0, 0)
        run_case(torch, itdq_case(dev, bd, H, W, seed=100), results, 10, 1)
        run_case(torch, itdq_case(dev, bd, H, W, seed=110, iqt=True),
                 results, 10, 1, main=bd == 8)

    log("phase mc (Baseline and Main taps)")
    for bd in (8, 10):
        for main_taps in (False, True):
            for is_luma in (True, False):
                for case in range(4):
                    run_case(torch, mc_size_case(dev, is_luma, case, bd,
                                                 seed=250,
                                                 main_taps=main_taps),
                             results, 10, 3)
        run_case(torch, mc_case(dev, 1080, 1920, bd, seed=260), results, 10,
                 3)

    log("phase recon/pad")
    for bd in (8, 10):
        run_case(torch, recon_case(dev, bd, BORDER + H + PAD_R,
                                   BORDER + W + PAD_R, seed=200),
                 results, 50, 50)
        run_case(torch, recon_pred_case(dev, bd, BORDER + H + PAD_R,
                                        BORDER + W + PAD_R, seed=230),
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

    log("phase intra_scan_wave (CIF, random EIPD CU lists, levels, HTDF)")
    for bd in (8, 10):
        for chroma, htdf in ((True, True), (False, True), (True, False)):
            run_case(torch, intra_wave_case(dev, 288, 352, bd, chroma,
                                            seed=500 + bd, htdf=htdf),
                     results, 10, 0)

    log("phase deblock")
    for bd in (8, 10):
        for kind in ("luma_ver", "luma_hor", "chroma_ver", "chroma_hor"):
            run_case(torch, deblock_case(dev, kind, bd, 270, 480, seed=400),
                     results, 20, 3, main=bd == 8)


def mc_main_path(torch, dev, packed, results, label, main):
    """The MC kernel against its plain version on a 1080p stream's own
    inter frames: the block tables and reference planes (the DPB's
    pictures, still on the card) that the main path hands the kernel;
    `main` marks the first frame's times as the summary's."""
    from tests.torch_helpers import mc_table_case
    from xevd_tpu_torch.ops import pack as PK

    log(f"phase mc ({label} frames)")
    inter = [pf for pf in packed if pf.refs]
    if not inter:
        raise AssertionError(f"{label}: no frame with inter CUs")
    for i, pf in enumerate(inter):
        df = PK.upload(pf, dev)
        shape = (f"{label} frame {i + 1}, {pf.mc_lists[0]}+{pf.mc_lists[1]} "
                 f"blocks{', Main taps' if pf.main_taps else ''}")
        run_case(torch, mc_table_case(dev, df.mc, pf.mc_lists, pf.refs,
                                      pf.shp_y, pf.shp_c, pf.bd, shape,
                                      pf.main_taps),
                 results, 10, 3, main=main and i == 0)


def intra_main_path(torch, dev, packed, results):
    """The intra scan kernel against its plain version on the 1080p
    stream's own frames: the CU tables, residual and picture planes that
    the main path hands the kernel."""
    from tests.torch_helpers import intra_planes_case, planes_before_intra

    log("phase intra_scan (1080p stream frames)")
    for i, pf in enumerate(packed):
        recs, resids, df = planes_before_intra(pf, dev)
        shape = (f"1080p frame {i}, {df.icu.shape[0]} CUs, "
                 f"{pf.shp_y[0]}x{pf.shp_y[1]}")
        run_case(torch, intra_planes_case(dev, recs, resids, df.icu, pf.bd,
                                          pf.chroma, shape),
                 results, 5, 0, main=i == 0)


def intra_wave_main_path(torch, dev, packed, results):
    """The EIPD scan kernel against its plain version on the 1080p Main
    stream's own I picture and its B picture with the most scan CUs: the
    CU tables, level schedules, residual and picture planes (after ITDQ,
    MC and recon) that the main path hands the kernel."""
    from tests.torch_helpers import intra_wave_planes_case, planes_before_intra

    log("phase intra_scan_wave (1080p Main stream pictures)")
    intra = [pf for pf in packed if not pf.refs]
    inter = [pf for pf in packed if pf.refs]
    if not intra or not inter:
        raise AssertionError("the Main stream lacks an I or a B picture")
    b = max(inter, key=lambda pf: pf.layout["icu"][1][0])
    for i, (kind, pf) in enumerate((("I", intra[0]), ("B", b))):
        recs, resids, df = planes_before_intra(pf, dev)
        shape = (f"1080p Main {kind} picture, {df.icu.shape[0]} CUs, "
                 f"{len(pf.level_off) - 1} levels")
        run_case(torch, intra_wave_planes_case(
            dev, recs, resids, df.icu, pf.level_off, pf.bd, pf.chroma, shape),
            results, 5, 0, main=i == 0)


# --------------------------------------------------------------------------
# slice phase
# --------------------------------------------------------------------------
def prepare_stream(name):
    """Worker: generate stream `name` (cached under tests/fixtures) and
    decode it with the numpy oracle backend to WORK/<name>_np.yuv; returns
    (name, frames, generation s, numpy decode s)."""
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
    from xevd_tpu.decoder import NumpyPixelBackend
    w, h, n, qp, seed, gop, density, bd, profile, tools, intra_frac = \
        STREAMS[name]
    path = STREAM_DIR / f"torch_smoke_{name}.evc"
    t0 = time.perf_counter()
    if not path.exists():
        import evc_enc
        data = evc_enc.encode_stream(
            w, h, n, qp, seed, gop, density, bd=bd, profile=profile,
            tools=evc_enc.Tools(**{k: 1 for k in tools}),
            intra_frac=intra_frac)
        STREAM_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(data)
        tmp.replace(path)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    frames = decode_to_yuv(path.read_bytes(), NumpyPixelBackend(),
                           WORK / f"{name}_np.yuv")
    return name, frames, t_gen, time.perf_counter() - t0


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


def counted_run(torch, K, backend, name, reps, marks, stages):
    """Decode stream `name` `reps` times through the main path with the
    launch counters reset just before; each run's output must equal the
    numpy backend's.  Returns (counts, frames/s per run, stage ms a frame
    of the last run)."""
    path = STREAM_DIR / f"torch_smoke_{name}.evc"
    data = path.read_bytes()
    want = (WORK / f"{name}_np.yuv").read_bytes()
    runs = []
    torch.cuda.synchronize()
    K.reset_counts()
    for rep in range(reps):
        marks.clear()
        t0 = time.perf_counter()
        n = decode_to_yuv(data, backend, WORK / f"{name}_t2.yuv")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if (WORK / f"{name}_t2.yuv").read_bytes() != want:
            raise AssertionError(f"{name} timed run: output differs from "
                                 "numpy")
        stage_ms = {s: 0.0 for s in stages}
        for i, (stage, ev, t) in enumerate(marks):
            if stage == "start":
                continue
            _, prev_ev, prev_t = marks[i - 1]
            stage_ms[stage] += ((t - prev_t) * 1e3 if stage == "pack"
                                else prev_ev.elapsed_time(ev))
        stage_ms = {k: v / n for k, v in stage_ms.items()}
        device_ms = sum(v for k, v in stage_ms.items() if k != "pack")
        runs.append(n / wall)
        log(f"  {name} timed run {rep}: {n} frames in {wall:.4f} s = "
            f"{n / wall:.3f} frames/s (host entropy + pack + device + 10-bit "
            f"write); device stages {device_ms:.3f} of {wall * 1e3 / n:.3f} "
            f"ms a frame ({100 * device_ms * n / (wall * 1e3):.1f} %)")
        log("    per frame, ms (pack: host clock incl. copies; others: CUDA "
            "events between stage marks): " +
            ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()))
    counts = dict(K.launch_counts)
    log(f"  launch counts during the {name} runs: {counts}")
    return counts, runs, stage_ms


def slice_phase(torch, dev, K, results, prepared):
    from xevd_tpu_torch import TorchPixelBackend
    from xevd_tpu_torch.app import main as app_main
    from xevd_tpu_torch.ops.pipeline import STAGES

    class KeepingBackend(TorchPixelBackend):
        """Keeps each frame's host payload, to replay its kernels."""

        def __init__(self, device):
            super().__init__(device=device)
            self.packed = []

        def pack_frame(self, job, sps, refp):
            pf = super().pack_frame(job, sps, refp)
            self.packed.append(pf)
            return pf

    log("phase slice: streams (numpy oracle decodes in worker processes)")
    packed = {}
    for name in STREAMS:
        _, n_np, t_gen, t_np = prepared[name].get()
        path = STREAM_DIR / f"torch_smoke_{name}.evc"
        t0 = time.perf_counter()
        backend = KeepingBackend(dev)
        n_t = decode_to_yuv(path.read_bytes(), backend, WORK / f"{name}_t.yuv")
        packed[name] = backend.packed
        torch.cuda.synchronize()
        t_t = time.perf_counter() - t0
        a = (WORK / f"{name}_np.yuv").read_bytes()
        b = (WORK / f"{name}_t.yuv").read_bytes()
        nfr = FRAMES.get(name, STREAMS[name][2])
        if n_np != nfr or n_t != nfr or a != b:
            raise AssertionError(f"{name}: torch ({n_t} frames) != numpy "
                                 f"({n_np} frames), {len(a)} vs {len(b)} B")
        log(f"  {name}: {nfr} frames, 10-bit YUV equal to NumpyPixelBackend "
            f"({len(a)} B); stream {t_gen:.2f} s, numpy {t_np:.2f} s, torch "
            f"first run {t_t:.2f} s")
    intra_main_path(torch, dev, packed["1080p_i"], results)
    mc_main_path(torch, dev, packed["1080p_p"], results, "1080p P", False)
    mc_main_path(torch, dev, packed["1080p_main_ra"], results, "1080p Main B",
                 True)
    intra_wave_main_path(torch, dev, packed["1080p_main_ra"], results)
    packed.clear()

    # the port's CLI entry point on the RA stream (B frames, both lists) and
    # on the CIF Main stream
    for name in ("cif10_ra", "cif10_main_p"):
        out = WORK / f"{name}_app.yuv"
        rc = app_main(["-i", str(STREAM_DIR / f"torch_smoke_{name}.evc"),
                       "-o", str(out), "--output-bit-depth", "10",
                       "--device", dev.type, "-v", "0"])
        if rc != 0 or out.read_bytes() != \
                (WORK / f"{name}_np.yuv").read_bytes():
            raise AssertionError(f"xevd_tpu_torch.app on {name}: rc {rc} or "
                                 "output differs")
        log(f"  python -m xevd_tpu_torch.app --device cuda: {name} output "
            "equal")

    # the counted, timed main paths through Decoder + torch backend: the
    # 1080p all-intra decode once, the 1080p IPPP decode twice, the 1080p
    # Main RA decode three times (the spread of the host clock); each path
    # must launch the kernels it names and none it excludes
    marks = []

    def on_stage(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev, time.perf_counter()))

    backend = TorchPixelBackend(device=dev, on_stage=on_stage)
    runs = {}
    for name, reps, excluded in (
            ("1080p_i", 1, ("mc", "intra_scan_wave")),
            ("1080p_p", TIMED_RUNS_BASELINE, ("intra_scan_wave",)),
            ("1080p_main_ra", TIMED_RUNS, ("intra_scan",))):
        counts, fps, stage_ms = counted_run(torch, K, backend, name, reps,
                                            marks, STAGES)
        missing = [k for k, v in counts.items()
                   if v == 0 and k not in excluded]
        stray = [k for k in excluded if counts[k]]
        if missing or stray:
            raise AssertionError(f"{name} path: kernels never launched "
                                 f"{missing}, or launched {stray} ({counts})")
        runs[name] = (counts, fps, stage_ms)
    return runs


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
    WORK.mkdir(parents=True, exist_ok=True)
    # the streams and their numpy decodes take minutes of host time: they
    # run in worker processes while the kernels build and are compared
    with multiprocessing.get_context("spawn").Pool(len(STREAMS)) as pool:
        prepared = {name: pool.apply_async(prepare_stream, (name,))
                    for name in STREAMS}
        K.build(verbose=True)      # always from this checkout's sources
        K.lib()
        log(f"build: nvcc {K.build_seconds:.1f} s, one process a source "
            f"({', '.join(K.SOURCES)} -> {K.BUILD_DIR.relative_to(REPO)})")

        results = {}
        kernel_phases(torch, dev, results)
        runs = slice_phase(torch, dev, K, results, prepared)

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = results[name]
        path = "1080p_p" if name == "intra_scan" else "1080p_main_ra"
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces,
                        "launches": runs[path][0][name],
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"]})
    for name, (_, fps, stage_ms) in runs.items():
        log(f"slice {name}: frames/s {[round(f, 3) for f in fps]}; stage "
            f"ms/frame {json.dumps(stage_ms)}")
    log(f"total smoke time {time.perf_counter() - t_start:.1f} s")
    log(gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
