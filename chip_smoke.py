#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (xevd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), torch/CUDA versions
   and which entropy engine runs; exits non-zero without a CUDA device.
   Starts, each as a program of its own (tests/torch_reference.py), the
   generation of the nine test streams (tools/evc_enc, seeded) and their
   decodes by `xevd_tpu`'s numpy oracle backend, the reference.
2. Builds the CUDA kernels from xevd_tpu_torch/csrc with nvcc (sm_90a).
3. Kernel phases: every hand-written kernel against its plain PyTorch
   version on the card, on numpy-seeded inputs at the shapes of the 1080p
   main paths, with exact equality (integer kernels, tolerance 0), and
   both times: ITDQ Baseline, Main iqt and every ATS basis pair; MC with
   the Baseline and the Main taps at every (plane, case, bit depth) and on
   a synthetic 1080p frame; recon, pad, deblock, the SUCO-order chroma
   deblock, the four ADDB passes and ALF luma and chroma (CTU 64 and 128,
   across tiles or not); the Baseline intra scan and the EIPD wavefront
   scan with HTDF on CIF with random CU lists (step 4 holds the scans, MC,
   the SUCO order, ADDB and ALF to their plain versions on the streams'
   own frames).
4. Slice phase: nine streams are decoded with Decoder(backend=
   TorchPixelBackend("cuda")); each 10-bit YUV must equal the numpy
   oracle's: 1920x1080 Baseline all-intra (2 frames), 352x288 10-bit
   all-intra (4), 1920x1080 Baseline IPPP (4: bench.py's config-2 stream
   cut from 16 frames), 352x288 10-bit RA (5, bi-prediction), 1920x1080
   Main RA with bench.py's 14 config-3 tools (5 pictures: config 3 cut
   from 9 frames to 3), the same 1080p Main RA stream with 12 tools, SUCO
   without ADDB and ALF (the SUCO-order chroma deblock path), and with 11
   tools, without SUCO, ADDB and ALF (the raster Baseline deblock on the
   Main path), and 352x288 10-bit Main IPPP with DRA, iqt, ATS and HTDF
   (4), once with ADDB and ALF and once without (the Baseline deblock at
   10 bit).  The
   Baseline intra scan kernel is held to its plain version on every 1080p
   intra frame's own CU table and planes, the MC kernel on every 1080p P
   frame's own block table and on the config-3 stream's B pictures (Main
   taps), the EIPD scan kernel on its I picture and one B picture, the
   SUCO order on the SUCO stream's pictures, ADDB and ALF on the config-3
   and the CIF 10-bit Main streams' pictures.  The CLI entry point decodes
   the CIF RA and both CIF Main streams.  Six paths are counted and timed:
   the 1080p all-intra decode once, the 1080p IPPP decode twice, the
   11-tool Main stream, the CIF 10-bit Main stream without ADDB and ALF and
   the SUCO stream once each, and the config-3 stream (the main path)
   three times; the
   launch counters are reset just before each path and read just after
   it; every kernel the path needs must have launched, and none it must
   not.  Each counted decode prints its frames/s and per-stage CUDA-event
   times.
5. Prints {"kernels": [...]} (launches from the config-3 path; the
   Baseline intra scan's and deblock's from the IPPP path, the SUCO
   order's from the SUCO path; each kernel's bound from its main case's
   bytes and operations) and, as the last line, {"ok": true, "device":
   {...}}.

Any failure raises and the exit code is non-zero.  Imports neither JAX
nor `xevd_tpu`: the reference runs in its own processes.
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
TIMED_RUNS = 3          # of the main path (bench config 3)
TIMED_RUNS_BASELINE = 2  # of the 1080p IPPP path
# bench.py's config-3 tools (bench.py:29-30)
MAIN_TOOLS = ("eipd", "cm_init", "btt", "suco", "adcc", "admvp", "hmvp",
              "mmvd", "amvr", "iqt", "ats", "addb", "htdf", "alf")
# config 3 without ADDB and ALF: SUCO then orders the chroma deblock (K10)
SUCO_TOOLS = tuple(t for t in MAIN_TOOLS if t not in ("addb", "alf"))
# config 3 without SUCO, ADDB and ALF: the raster Baseline deblock (K8/K9)
RASTER_TOOLS = tuple(t for t in SUCO_TOOLS if t != "suco")
CIF10_MAIN_TOOLS = ("dra", "eipd", "cm_init", "admvp", "hmvp", "iqt", "ats",
                    "htdf")
# name -> tools/evc_enc.encode_stream arguments (w, h, frames, qp, seed,
# gop, density, bd, profile, tools, intra_frac)
STREAMS = {
    "1080p_main_c3": (1920, 1080, 3, 32, 779, "RA", 0.3, 8, 1, MAIN_TOOLS,
                      0.1),
    "1080p_main_suco": (1920, 1080, 3, 32, 779, "RA", 0.3, 8, 1, SUCO_TOOLS,
                        0.1),
    "1080p_main_ra": (1920, 1080, 3, 32, 779, "RA", 0.3, 8, 1, RASTER_TOOLS,
                      0.1),
    "1080p_p": (1920, 1080, 4, 32, 777, "IPPP", 0.3, 8, 0, (), 0.35),
    "1080p_i": (1920, 1080, 2, 32, 777, "I", 0.3, 8, 0, (), 0.35),
    "cif10_main_alf": (352, 288, 4, 30, 802, "IPPP", 0.5, 10, 1,
                       CIF10_MAIN_TOOLS + ("addb", "alf"), 0.35),
    "cif10_main_p": (352, 288, 4, 30, 802, "IPPP", 0.5, 10, 1,
                     CIF10_MAIN_TOOLS, 0.35),
    "cif10_i": (352, 288, 4, 32, 778, "I", 0.5, 10, 0, (), 0.35),
    "cif10_ra": (352, 288, 5, 32, 779, "RA", 0.5, 10, 0, (), 0.35),
}
# frames each stream decodes to (RA rounds up to a whole GOP)
FRAMES = {"1080p_main_c3": 5, "1080p_main_suco": 5, "1080p_main_ra": 5}
# the card's peaks for a kernel's bound (H100 SXM datasheet figures):
# HBM bytes/s; integer operations/s taken at the scalar (non-tensor)
# float32 FMA rate counted as two operations, a deliberate upper peak: the
# int32 issue rate is lower, so the operations term never overstates
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

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
    "chroma_ver_ordered": ("cuda", "xevd_tpu_torch/csrc/deblock.cu",
                           "xevd_tpu/ops/jax_deblock.py:123"),
    "addb_luma_ver": ("cuda", "xevd_tpu_torch/csrc/addb.cu",
                      "xevd_tpu/ops/jax_deblock.py:200"),
    "addb_luma_hor": ("cuda", "xevd_tpu_torch/csrc/addb.cu",
                      "xevd_tpu/ops/jax_deblock.py:217"),
    "addb_chroma_ver": ("cuda", "xevd_tpu_torch/csrc/addb.cu",
                        "xevd_tpu/ops/jax_deblock.py:232"),
    "addb_chroma_hor": ("cuda", "xevd_tpu_torch/csrc/addb.cu",
                        "xevd_tpu/ops/jax_deblock.py:247"),
    "alf_luma": ("cuda", "xevd_tpu_torch/csrc/alf.cu",
                 "xevd_tpu/ops/jax_alf.py:150"),
    "alf_chroma": ("cuda", "xevd_tpu_torch/csrc/alf.cu",
                   "xevd_tpu/ops/jax_alf.py:150"),
}
# the counted path whose launches the kernels line reports, where it is
# not the main path (the config-3 stream, whose deblock is ADDB)
PATH_OF = {"intra_scan": "1080p_p", "deblock_luma_ver": "1080p_p",
           "deblock_luma_hor": "1080p_p", "deblock_chroma_ver": "1080p_p",
           "deblock_chroma_hor": "1080p_p",
           "chroma_ver_ordered": "1080p_main_suco"}
MAIN_PATH = "1080p_main_c3"


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
        r.update(ms=ms, plain_ms=plain_ms, shape=case.shape,
                 bytes=case.bytes, ops=case.ops)
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
    from tests.torch_helpers import (addb_case, alf_case, deblock_case,
                                     intra_case, intra_wave_case, itdq_case,
                                     itdq_size_case, mc_case, mc_size_case,
                                     pad_case, recon_case, recon_pred_case,
                                     suco_case)
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

    log("phase chroma_ver_ordered (SUCO order; 1080p chroma, random edges)")
    for bd in (8, 10):
        run_case(torch, suco_case(dev, bd, 270, 480, seed=600), results, 20, 3)

    log("phase addb (1080p luma and chroma, U and V channels)")
    for bd in (8, 10):
        for kind, cb in (("luma_ver", 1), ("luma_hor", 1), ("chroma_ver", 1),
                         ("chroma_ver", 4), ("chroma_hor", 1),
                         ("chroma_hor", 4)):
            H, W = (1080, 1920) if kind.startswith("luma") else (540, 960)
            run_case(torch, addb_case(dev, kind, bd, H, W, seed=650, cb=cb),
                     results, 20, 3)

    log("phase alf (1080p, CTU 64 and 128, across tiles or not)")
    for bd in (8, 10):
        for luma in (True, False):
            for log2_ctu, across in ((6, 1), (6, 0), (7, 1)):
                run_case(torch, alf_case(dev, luma, bd, 1080, 1920, log2_ctu,
                                         across, seed=700), results, 20, 1)


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


SUCO_KERNELS = ("chroma_ver_ordered",)
ADDB_KERNELS = ("addb_luma_ver", "addb_luma_hor", "addb_chroma_ver",
                "addb_chroma_hor")
ALF_KERNELS = ("alf_luma", "alf_chroma")


def frame_main_path(torch, dev, packed, results, label, kernels, main):
    """The SUCO-order chroma deblock, the ADDB passes and the ALF kernels
    against their plain versions on a stream's own pictures: the areas,
    edge tables, parameter maps, coefficients and CTU flags the main path
    hands them (each picture run through the path's own stages up to that
    kernel).  `kernels` names the kernels to hold, each of which some
    picture must run; `main` marks the times of the picture with the most
    work as the summary's."""
    from tests.torch_helpers import (addb_planes_case, alf_planes_case,
                                     frame_areas_before, suco_planes_case)

    log(f"phase {', '.join(kernels)} ({label} pictures)")
    cases = []
    for i, pf in enumerate(packed):
        if "chroma_ver_ordered" in kernels and pf.suco:
            (_, u, v), df = frame_areas_before(pf, dev, "deblock")
            chain = int((df.suco_off[1:] - df.suco_off[:-1]).max())
            cases.append(suco_planes_case(
                dev, u, v, df.suco_off, df.suco_edges, pf.bd,
                f"{label} picture {i}, {df.suco_edges.shape[0]} edges, "
                f"longest row {chain}"))
        if ADDB_KERNELS[0] in kernels and pf.addb:
            areas, df = frame_areas_before(pf, dev, "deblock")
            for kind, a, pars, cb in (
                    ("luma_ver", areas[0], df.addb_l[0], 1),
                    ("luma_hor", areas[0], df.addb_l[1], 1),
                    ("chroma_ver", areas[1], df.addb_c[0], 1),
                    ("chroma_ver", areas[2], df.addb_c[0], 4),
                    ("chroma_hor", areas[1], df.addb_c[1], 1),
                    ("chroma_hor", areas[2], df.addb_c[1], 4)):
                cases.append(addb_planes_case(
                    dev, kind, a, pars, pf.bd, cb, f"{label} picture {i}, "
                    f"{a.shape[0]}x{a.shape[1]} cb{cb}"))
        if ALF_KERNELS[0] in kernels and pf.alf is not None:
            areas, df = frame_areas_before(pf, dev, "alf")
            (en, log2_ctu, across), (h, w) = pf.alf, pf.geom[:2]
            for plane, area in enumerate(areas):
                if area is None or not en[plane]:
                    continue
                luma = plane == 0
                cases.append(alf_planes_case(
                    dev, luma, area, df.alf_l if luma else df.alf_c,
                    df.alf_on, h >> (not luma), w >> (not luma),
                    log2_ctu - (not luma), pf.bd, across,
                    f"{label} picture {i}, {'YUV'[plane]}, CTU "
                    f"{1 << log2_ctu}"))
    missing = set(kernels) - {c.name for c in cases}
    if missing:
        raise AssertionError(f"{label}: no picture runs {missing}")
    best = {}
    for c in cases:
        if c.name not in best or c.bytes > best[c.name].bytes:
            best[c.name] = c
    for c in cases:
        run_case(torch, c, results, 10, 1, main=main and best[c.name] is c)


# --------------------------------------------------------------------------
# slice phase
# --------------------------------------------------------------------------
def start_reference(name):
    """Start the reference worker for stream `name` (a program of its own:
    tests/torch_reference.py generates the stream, cached under
    tests/fixtures, and decodes it with xevd_tpu's numpy oracle to
    WORK/<name>_np.yuv)."""
    return subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_reference.py"),
         json.dumps(STREAMS[name]),
         str(STREAM_DIR / f"torch_smoke_{name}.evc"),
         str(WORK / f"{name}_np.yuv")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def reference_result(proc, name):
    """(frames, generation s, numpy decode s) of a finished worker."""
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"reference worker for {name} failed "
                             f"(rc {proc.returncode}):\n{err[-4000:]}")
    r = json.loads(out.strip().splitlines()[-1])
    return r["frames"], r["gen_s"], r["numpy_s"]


def decode_to_yuv(data: bytes, backend, out: Path) -> int:
    """Decode a length-prefixed NALU stream with the port's Decoder and
    write 10-bit YUV; returns the number of frames written."""
    from xevd_tpu_torch.host import NAL_UNIT_LENGTH_BYTE, Decoder, info
    from xevd_tpu_torch.host.utils.yuv import YuvWriter

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
        n_np, t_gen, t_np = reference_result(prepared[name], name)
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
    mc_main_path(torch, dev, packed[MAIN_PATH], results, "1080p Main B",
                 True)
    intra_wave_main_path(torch, dev, packed[MAIN_PATH], results)
    frame_main_path(torch, dev, packed["1080p_main_suco"], results,
                    "1080p SUCO", SUCO_KERNELS, True)
    frame_main_path(torch, dev, packed[MAIN_PATH], results, "1080p config-3",
                    ADDB_KERNELS + ALF_KERNELS, True)
    frame_main_path(torch, dev, packed["cif10_main_alf"], results,
                    "CIF 10-bit Main", ADDB_KERNELS + ALF_KERNELS, False)
    packed.clear()

    # the port's CLI entry point on the RA stream (B frames, both lists) and
    # on the CIF Main streams
    for name in ("cif10_ra", "cif10_main_p", "cif10_main_alf"):
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

    # the counted, timed paths through Decoder + torch backend: the 1080p
    # all-intra decode once, the 1080p IPPP decode twice, the 11-tool Main,
    # CIF 10-bit Main and SUCO streams once each, the config-3 stream three
    # times (the spread of the host clock); each path must launch the
    # kernels it needs and none it must not
    marks = []

    def on_stage(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev, time.perf_counter()))

    backend = TorchPixelBackend(device=dev, on_stage=on_stage)
    common = ("itdq", "recon", "pad")
    baseline_db = ("deblock_luma_ver", "deblock_luma_hor",
                   "deblock_chroma_ver", "deblock_chroma_hor")
    addb, alf = ADDB_KERNELS, ALF_KERNELS
    runs = {}
    for name, reps, needed, barred in (
            ("1080p_i", 1, common + ("intra_scan",) + baseline_db,
             ("mc", "intra_scan_wave", "chroma_ver_ordered") + addb + alf),
            ("1080p_p", TIMED_RUNS_BASELINE,
             common + ("mc", "intra_scan") + baseline_db,
             ("intra_scan_wave", "chroma_ver_ordered") + addb + alf),
            ("1080p_main_ra", 1,
             common + ("mc", "intra_scan_wave") + baseline_db,
             ("intra_scan", "chroma_ver_ordered") + addb + alf),
            ("cif10_main_p", 1,
             common + ("mc", "intra_scan_wave") + baseline_db,
             ("intra_scan", "chroma_ver_ordered") + addb + alf),
            ("1080p_main_suco", 1,
             common + ("mc", "intra_scan_wave", "chroma_ver_ordered",
                       "deblock_luma_ver", "deblock_luma_hor",
                       "deblock_chroma_hor"),
             ("intra_scan",) + addb + alf),
            (MAIN_PATH, TIMED_RUNS,
             common + ("mc", "intra_scan_wave") + addb + alf,
             ("intra_scan", "chroma_ver_ordered") + baseline_db)):
        counts, fps, stage_ms = counted_run(torch, K, backend, name, reps,
                                            marks, STAGES)
        missing = [k for k in needed if counts[k] == 0]
        stray = [k for k in barred if counts[k]]
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
    from xevd_tpu_torch.host import native
    from xevd_tpu_torch.kernels import build as K

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}, "
        f"native entropy engine: {native.available()}")
    WORK.mkdir(parents=True, exist_ok=True)
    # the streams and their numpy decodes take minutes of host time: the
    # reference workers run while the kernels build and are compared
    prepared = {name: start_reference(name) for name in STREAMS}
    try:
        K.build(verbose=True)      # always from this checkout's sources
        K.lib()
        log(f"build: nvcc {K.build_seconds:.1f} s, one process a source "
            f"({', '.join(K.SOURCES)} -> {K.BUILD_DIR.relative_to(REPO)})")

        results = {}
        kernel_phases(torch, dev, results)
        runs = slice_phase(torch, dev, K, results, prepared)
    finally:
        for p in prepared.values():
            if p.poll() is None:
                p.kill()
            p.communicate()

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = results[name]
        t_bytes = r["bytes"] / HBM_BYTES_PER_S
        t_ops = r["ops"] / SCALAR_OPS_PER_S
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces,
                        "launches": runs[PATH_OF.get(name, MAIN_PATH)][0][
                            name],
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": max(t_bytes, t_ops) * 1e3,
                        "bound_by": "bytes" if t_bytes >= t_ops
                        else "operations",
                        # no single PyTorch call computes any of these
                        # integer pipelines (PERF.md)
                        "library_ms": None,
                        "shape": r["shape"]})
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
