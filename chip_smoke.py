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
   both times: ITDQ Baseline, Main iqt and every ATS basis pair; MC on a
   frame of every class of its kernel (plane group, size, case; windows
   at the planes' edges, phase 0 under filtering cases, split 64x64
   blocks) at 8 and 10 bit with the Baseline and the Main taps, 10
   launches a case, with the Baseline and the Main taps at every (plane,
   case, bit depth) and on a synthetic 1080p frame; recon, pad (beside
   torch.nn.functional.pad(mode="replicate"), its library yardstick, or
   CUDA's refusal of int16), deblock, the SUCO-order chroma
   deblock, the four ADDB passes and ALF luma and chroma (CTU 64 and 128,
   across tiles or not); ITDQ on a frame of every size class (2x2 to
   64x64, square and rectangular, Baseline beside ATS and all Main, and at
   the largest scale with coefficients over the whole int16 range), 10
   launches a case; K9 (the Baseline chroma deblock cascade) on random
   maps, maps with every edge on and an empty one at 8 and 10 bit, 20
   launches a case; the Baseline intra scan on CIF with random causal
   CU lists and on 4x4 CUs with every causal bit set, and the EIPD
   wavefront scan with HTDF on CIF with random CU lists (step 4 holds the
   scans, MC, the SUCO order, ADDB and ALF to their plain versions on the
   streams' own frames).  The two scans are persistent dataflow kernels:
   each of their cases, here and in steps 4 and 5, runs the plain version
   once and the kernel 20 times from the same inputs, every launch equal
   (a race shows as a difference between launches).
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
   intra frame's own CU table and planes and on the 1080p IPPP stream's P
   frame with the most intra CUs, K9 on every IPPP frame's own chroma
   areas and maps (20 launches each; the run lengths of each map
   printed), ITDQ on every config-3 and IPPP frame's own TU table (10
   launches; the TUs of each size class and the host time of the class
   grouping printed), the MC kernel on every 1080p P
   frame's own block table and class order and on the config-3 stream's
   B pictures (Main taps; 10 launches each; the rows of each class and the
   host time of `mc_order` printed), the EIPD scan kernel on its I picture
   and one B picture, the
   SUCO order on the SUCO stream's pictures, ADDB and ALF on the config-3
   and the CIF 10-bit Main streams' pictures.  The CLI entry point decodes
   the CIF RA and both CIF Main streams.  Six paths are counted and timed:
   the 1080p all-intra decode once, the 1080p IPPP decode twice, the
   11-tool Main stream, the CIF 10-bit Main stream without ADDB and ALF and
   the SUCO stream once each, and the config-3 stream (the main path)
   three times; the
   launch counters are reset just before each path and read just after
   it; every kernel the path needs must have launched, and none it must
   not; MC once a reference list with blocks, per frame.  Each counted
   decode prints its frames/s and per-stage CUDA-event
   times.
5. GOP phase (K15, xevd_tpu_torch/parallel/gop.py): 8 independent
   1920x1080 Baseline IPPP GOPs of 2, 3 or 4 frames (xevd_tpu/parallel/
   gop.py `gen_gop_streams(8, 1920, 1080, frames=2, variable=True)`'s
   encoder settings), each generated by a reference worker and captured
   (decoded serially by the numpy oracle backend, each frame's pack kept)
   by the port's host decoder in a worker (`python -m
   xevd_tpu_torch.parallel.gop --capture`).  Every batched
   kernel, and the whole batched step, is held to its batched plain
   version on the batch's own step-1 (P) tables and DPB at G = 8 and G =
   1; then all 8 GOPs decode as one batch per time step on the card
   (counted: each batched kernel once a step, the intra scan once a step,
   not once a frame), twice, and every frame's MD5 must equal the numpy
   oracle's serial decode; the same 8 GOPs then decode serially through
   Decoder + TorchPixelBackend("cuda"), equal too, for the record.  The
   pad kernel (K14) is timed a second time once every worker has ended.
   Then forty 64x64 two-frame IPPP GOPs (one reference worker writes the
   streams; captured here) decode as one batch on the card, 40 DPB ring
   pictures (more than a frame's 32 MC slots): every batched kernel held
   to its plain version on step 1 (MC in 10 launches), every frame's MD5
   equal to the oracle's.  Last, eight 176x144 Main IPPP GOPs with iqt,
   ATS, ADMVP and cm_init (the batched Main-tap MC; one reference worker
   writes the streams; captured here): every batched kernel held on step
   1 at G = 8 and G = 1 (MC in 10 launches, timed), every MD5 of the
   batch equal to the oracle's.
6. Prints each scan case's time with the DAG depth (K5) or level count
   (K6) of its frame and the persistent grids, then {"kernels": [...]}
   (launches from the config-3 path; the Baseline intra scan's and
   deblock's from the IPPP path, the SUCO order's from the SUCO path, the
   batched kernels' (gop_*) and K15's from the GOP path; each kernel's
   bound from its main case's bytes and operations; every kernel also
   with `ms_device`, its time from CUDA-graph replays without the
   wrapper's host work; K9 with `ms_all` / `ms_zero` for the maps with
   every edge on and none; K14 with `library_ms`, F.pad's time, or
   `library_refused`) and, as the last line, {"ok": true,
   "device": {...}}.

Any failure raises and the exit code is non-zero.  Imports neither JAX
nor `xevd_tpu`: the reference runs in its own processes.
"""
from __future__ import annotations

import hashlib
import json
import pickle
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
# the GOP batch (K15): xevd_tpu/parallel/gop.py gen_gop_streams(8, 1920,
# 1080, frames=2, qp=30, variable=True), 2 + g % 3 frames each
GOP_SPECS = [(1920, 1080, 2 + g % 3, 30, 1000 + 7 * g, "IPPP", 0.5, 8, 0,
              (), 0.35) for g in range(8)]
TIMED_RUNS_GOP = 2
# the GOP batch past 32 DPB ring pictures: forty two-frame 64x64 IPPP GOPs
# on one card (D x G_dev = 40), generated by one reference worker
BIG_GOP_SPECS = [(64, 64, 2, 30, 3000 + 7 * g, "IPPP", 0.5, 8, 0, (), 0.35)
                 for g in range(40)]
# the GOP batch with the Main MC taps: eight 176x144 Main IPPP GOPs of 2, 3
# or 4 frames with iqt, ATS, ADMVP and cm_init (batched iqt/ATS ITDQ and
# Main-tap MC), generated by one reference worker
MAIN_GOP_TOOLS = ("iqt", "ats", "admvp", "cm_init")
MAIN_GOP_SPECS = [(176, 144, 2 + g % 3, 30, 1200 + 7 * g, "IPPP", 0.5, 8, 1,
                   MAIN_GOP_TOOLS, 0.35) for g in range(8)]
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
# the batched kernels of the GOP path (K15), "gop_" + their counter name,
# and K15's step itself
GOP_KERNELS = ("itdq", "mc", "recon", "intra_scan", "deblock_luma_ver",
               "deblock_chroma_ver", "deblock_luma_hor", "deblock_chroma_hor",
               "pad")
KERNELS.update({f"gop_{k}": KERNELS[k] for k in GOP_KERNELS})
KERNELS["gop_step"] = ("cuda", "xevd_tpu_torch/parallel/gop.py",
                       "xevd_tpu/parallel/gop.py:197")
# the counted path whose launches the kernels line reports, where it is
# not the main path (the config-3 stream, whose deblock is ADDB)
PATH_OF = {"intra_scan": "1080p_p", "deblock_luma_ver": "1080p_p",
           "deblock_luma_hor": "1080p_p", "deblock_chroma_ver": "1080p_p",
           "deblock_chroma_hor": "1080p_p",
           "chroma_ver_ordered": "1080p_main_suco"}
PATH_OF.update({k: "gop" for k in KERNELS if k.startswith("gop_")})
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


def graph_ms(torch, fn, reps):
    """Mean device milliseconds of fn() over `reps` replays of a CUDA graph
    that captured one call: the wrapper's host work (argument checks,
    ctypes) is left out, which back-to-back calls (`timed`) include where
    a kernel takes less time than its launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                        # allocations outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


SCAN_LAUNCHES = 20     # race check of each scan case (persistent kernels)
SCAN_NAMES = ("intra_scan", "intra_scan_wave")
SCANS = []             # (key, shape, kernel ms, plain ms) of each scan case
K9_LAUNCHES = 20       # each K9 case: launches equal to the plain version
ITDQ_LAUNCHES = 10     # each ITDQ class case
MC_LAUNCHES = 10       # each MC class-mix case and stream table


def run_case(torch, case, results, reps, plain_reps, main=False, key=None,
             launches=None):
    """Holds one kernel against its plain version (exact) and times both:
    `reps` kernel runs, `plain_reps` plain runs (0: the timed comparison
    run itself, for a plain version too slow to run twice).  The kernel
    is held `launches` times (a scan: SCAN_LAUNCHES; else 1), each launch
    from the same inputs (`case.reset`) against the plain version's one
    result.  `main` marks the case at the main path's shapes, whose times
    the summary reports; `key` files the result under another name than
    the kernel's.  Returns the kernel's ms."""
    from tests.torch_helpers import max_abs_err, repeat_equal
    got = case.kernel()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    want = case.plain()
    t1.record()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if launches is None:
        launches = SCAN_LAUNCHES if case.name in SCAN_NAMES else 1
    if launches > 1 and err == 0:
        err = repeat_equal(case, want, launches - 1)
    if err != 0:
        raise AssertionError(f"{case.name} {case.shape}: kernel != plain "
                             f"(max abs err {err}, {launches} launches)")
    ms = timed(torch, case.kernel, reps) if reps else None
    # device time too: CUDA-graph replays of one call, without the
    # wrapper's host work, which back-to-back calls include where a kernel
    # is shorter than its launch
    dms = graph_ms(torch, case.kernel, 2 * reps) if reps else None
    plain_ms = (timed(torch, case.plain, plain_reps) if plain_reps
                else t0.elapsed_time(t1))
    r = results.setdefault(key or case.name, {"max_abs_err": 0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["last_device_ms"] = dms
    if main:
        r.update(ms=ms, plain_ms=plain_ms, shape=case.shape,
                 bytes=case.bytes, ops=case.ops)
        if dms is not None:
            r["ms_device"] = dms
    timing = (f"kernel {ms:9.4f} ms  plain {plain_ms:10.4f} ms" if reps
              else "")
    if dms is not None:
        timing += f"  graph {dms:8.4f} ms"
    log(f"  {case.name:20s} {case.shape:34s} equal"
        f"{f' in {launches} launches' if launches > 1 else ''}  {timing}"
        f"{'  (main path)' if main else ''}")
    if case.name in SCAN_NAMES and reps:
        SCANS.append((key or case.name, case.shape, ms, plain_ms))
    return ms


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
    import numpy as np
    from tests.torch_helpers import (CHROMA_MAPS, addb_case, alf_case,
                                     chroma_map, deblock_case, intra_case,
                                     intra_chain_case, intra_wave_case,
                                     itdq_case, itdq_class_case,
                                     itdq_size_case, mc_case, mc_class_case,
                                     mc_size_case,
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
    log(f"phase itdq classes (every size class in one launch, "
        f"{ITDQ_LAUNCHES} launches a case)")
    for bd in (8, 10):
        for iqt in (False, True):
            for extreme in (False, True):
                run_case(torch, itdq_class_case(dev, bd, iqt, seed=120,
                                                extreme=extreme),
                         results, 10, 1, launches=ITDQ_LAUNCHES)

    log(f"phase mc classes (every class and case in each list's launch, "
        f"windows at the planes' edges, phase 0 under filtering cases, "
        f"split 64x64 blocks; {MC_LAUNCHES} launches a case)")
    for bd in (8, 10):
        for main_taps in (False, True):
            run_case(torch, mc_class_case(dev, bd, main_taps, seed=270),
                     results, 10, 3, launches=MC_LAUNCHES)
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
    pad_library(torch, dev, results)

    log("phase intra_scan (CIF, random causal CU lists; 4x4 CUs)")
    for bd in (8, 10):
        for chroma in (True, False):
            run_case(torch, intra_case(dev, 288, 352, bd, chroma,
                                       seed=300 + bd), results, 10, 1)
    run_case(torch, intra_chain_case(dev, 192, 256, 8, seed=310), results, 10,
             0)

    log("phase intra_scan_wave (CIF, random EIPD CU lists, levels, HTDF)")
    for bd in (8, 10):
        for chroma, htdf in ((True, True), (False, True), (True, False)):
            run_case(torch, intra_wave_case(dev, 288, 352, bd, chroma,
                                            seed=500 + bd, htdf=htdf),
                     results, 10, 0)

    log("phase deblock")
    for bd in (8, 10):
        for kind in ("luma_ver", "luma_hor", "chroma_ver", "chroma_hor"):
            chroma = kind.startswith("chroma")
            ms = run_case(torch, deblock_case(dev, kind, bd, 270, 480,
                                              seed=400),
                          results, 20, 3, main=bd == 8,
                          launches=K9_LAUNCHES if chroma else None)
            if chroma and bd == 8:
                results[f"deblock_{kind}"]["ms_pr6_case"] = ms
    log(f"phase K9 map kinds (1080p chroma; random, every edge on, no "
        f"edge; {K9_LAUNCHES} launches a case)")
    for bd in (8, 10):
        for kind in ("chroma_ver", "chroma_hor"):
            for maps in CHROMA_MAPS:
                rng = np.random.default_rng(410 + bd)
                ms = run_case(torch, deblock_case(
                    dev, kind, bd, 270, 480, seed=410,
                    st=chroma_map(rng, maps, 270, 480), label=f" {maps} map"),
                    results, 20, 1, launches=K9_LAUNCHES)
                if bd == 8:
                    r = results[f"deblock_{kind}"]
                    r[f"ms_{maps}"] = ms
                    r[f"ms_device_{maps}"] = r["last_device_ms"]

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


def pad_library(torch, dev, results):
    """K14's yardstick: one PyTorch call that computes `_pad_out`'s
    jnp.pad(mode="edge"), torch.nn.functional.pad(mode="replicate"), on
    the int16 picture of the main pad case (1080p luma, +PAD_L); equal to
    the kernel's output, timed by events and by graph replays; or CUDA's
    refusal of int16, recorded."""
    import numpy as np
    from tests.torch_helpers import bordered
    from xevd_tpu_torch.ops import recon as TR
    from xevd_tpu_torch.ops.tables import BORDER, PAD_L

    h, w = 1080, 1920
    rng = np.random.default_rng(210 + 8)
    plane = torch.from_numpy(bordered(rng, h, w, 0, 256)).to(dev)
    area = plane[BORDER:BORDER + h, BORDER:BORDER + w]
    r = results["pad"]

    def call():
        return torch.nn.functional.pad(area[None], (PAD_L,) * 4,
                                       mode="replicate")[0]
    try:
        got = call()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        r["library_refused"] = str(e).strip().splitlines()[0]
        log(f"  F.pad(mode='replicate') on int16 {h}x{w}: refused: "
            f"{r['library_refused']}")
        return
    if not torch.equal(got, TR.pad(area, h, w, PAD_L)):
        raise AssertionError("F.pad(mode='replicate') != the pad kernel")
    r["library_ms"] = timed(torch, call, 50)
    r["library_ms_device"] = graph_ms(torch, call, 100)
    log(f"  F.pad(mode='replicate') on int16 {h}x{w} +{PAD_L}: equal to the "
        f"pad kernel; {r['library_ms']:.4f} ms, graph "
        f"{r['library_ms_device']:.4f} ms")


def mc_main_path(torch, dev, packed, results, label, main):
    """The MC kernel against its plain version on a 1080p stream's own
    inter frames: the block tables, class orders and reference planes (the
    DPB's pictures, still on the card) that the main path hands the
    kernel, MC_LAUNCHES launches each; `main` marks the first frame's times
    as the summary's.  Prints each frame's MC rows by class and the host
    time of the grouping (ops/pack.py `mc_order`)."""
    import numpy as np
    from tests.torch_helpers import mc_class_histogram, mc_table_case
    from xevd_tpu_torch.ops import pack as PK

    log(f"phase mc ({label} frames)")
    inter = [pf for pf in packed if pf.refs]
    if not inter:
        raise AssertionError(f"{label}: no frame with inter CUs")
    for i, pf in enumerate(inter):
        df = PK.upload(pf, dev)
        table = df.mc.cpu().numpy()
        t = []
        for _ in range(20):
            t0 = time.perf_counter()
            o = PK.mc_order(table, pf.mc_lists)
            t.append(time.perf_counter() - t0)
        log(f"  {label} frame {i + 1}: {len(table)} MC rows in "
            f"{len(o.classes)} classes, {o.lists[0][2]}+{o.lists[1][2]} "
            f"CTAs; mc_order {min(t) * 1e3:.3f} ms (min of 20, median "
            f"{np.median(t) * 1e3:.3f}); rows a class (l luma, c chroma, w x "
            f"h, case): {mc_class_histogram(o)}")
        shape = (f"{label} frame {i + 1}, {pf.mc_lists[0]}+{pf.mc_lists[1]} "
                 f"blocks{', Main taps' if pf.main_taps else ''}")
        run_case(torch, mc_table_case(dev, df.mc, pf.mc_lists, pf.refs,
                                      pf.shp_y, pf.shp_c, pf.bd, shape,
                                      pf.main_taps, order=df.mc_order),
                 results, 10, 3, main=main and i == 0, launches=MC_LAUNCHES)


def intra_main_path(torch, dev, packed, results):
    """The intra scan kernel against its plain version on the 1080p
    streams' own frames: every all-intra frame and the IPPP stream's P
    frame with the most intra CUs, with the CU tables, residual and
    picture planes that the main path hands the kernel."""
    from tests.torch_helpers import intra_planes_case, planes_before_intra
    from xevd_tpu_torch.ops.intra import intra_dag_depth

    log("phase intra_scan (1080p stream frames)")
    p = max((pf for pf in packed["1080p_p"] if pf.refs),
            key=lambda pf: pf.layout["icu"][1][0])
    frames = [(f"intra frame {i}", pf)
              for i, pf in enumerate(packed["1080p_i"])] + [("P frame", p)]
    for i, (label, pf) in enumerate(frames):
        recs, resids, df = planes_before_intra(pf, dev)
        shape = (f"1080p {label}, {df.icu.shape[0]} CUs, depth "
                 f"{intra_dag_depth(df.icu, *pf.geom[2:])}")
        run_case(torch, intra_planes_case(dev, recs, resids, df.icu, pf.bd,
                                          pf.chroma, shape),
                 results, 5, 0, main=i == 0)


def deblock_main_path(torch, dev, packed, results):
    """K9 against its plain version on the 1080p IPPP stream's own frames:
    the chroma areas before deblock and the strength maps the path hands
    the two passes, K9_LAUNCHES launches each (the I frame's U plane is
    the summary's case); the I frame's maps also on 10-bit planes.  Prints
    each map's run lengths (consecutive edges with a strength)."""
    import numpy as np
    from tests.torch_helpers import (deblock_area_case, deblock_case,
                                     frame_areas_before, run_lengths)

    log("phase K9 (1080p IPPP frames' own chroma areas and maps)")
    for i, pf in enumerate(packed):
        areas, df = frame_areas_before(pf, dev, "deblock")
        ftype = "P" if pf.refs else "I"
        for kind, k in (("chroma_ver", 2), ("chroma_hor", 3)):
            for plane in (1, 2):
                st = df.dbst[k + 2 * (plane - 1)]
                runs = run_lengths(st.cpu().numpy(), kind)
                hist = np.bincount(runs) if len(runs) else np.zeros(1, int)
                hist = {n: int(c) for n, c in enumerate(hist) if c}
                log(f"  run lengths {kind} frame {i} ({ftype}) "
                    f"{'UV'[plane - 1]}: {len(runs)} runs, "
                    f"{int(runs.sum()) if len(runs) else 0} edges; length: "
                    f"count {hist}")
                shape = (f"1080p IPPP frame {i} ({ftype}) {'UV'[plane - 1]} "
                         f"{tuple(areas[plane].shape)}, {len(runs)} runs")
                run_case(torch, deblock_area_case(dev, kind, areas[plane], st,
                                                  pf.bd, shape),
                         results, 20, 1, main=i == 0 and plane == 1,
                         launches=K9_LAUNCHES)
            if i == 0:
                run_case(torch, deblock_case(
                    dev, kind, 10, *df.dbst.shape[1:], seed=420,
                    st=df.dbst[k].cpu().numpy(), label=" IPPP I-frame map"),
                    results, 20, 1, launches=K9_LAUNCHES)


def itdq_main_path(torch, dev, packed, results):
    """ITDQ against its plain version on the config-3 stream's pictures
    and the 1080p IPPP stream's frames: their own TU tables, coefficients
    and class orders, ITDQ_LAUNCHES launches each.  Prints each frame's TU
    count by size class and the host time of the grouping
    (ops/pack.py `itdq_order`)."""
    import numpy as np
    from tests.torch_helpers import KernelCase, itdq_work
    from xevd_tpu_torch.ops import itdq as TQ
    from xevd_tpu_torch.ops import pack as PK
    from xevd_tpu_torch.ops.tables import device_tables

    log("phase itdq (the streams' own TU tables)")
    tab = device_tables(dev)
    for name, label in ((MAIN_PATH, "config-3"), ("1080p_p", "1080p IPPP")):
        for i, pf in enumerate(packed[name]):
            df = PK.upload(pf, dev)
            tus = df.tus.cpu().numpy()
            t = []
            for _ in range(20):
                t0 = time.perf_counter()
                o = PK.itdq_order(tus, pf.iqt)
                t.append(time.perf_counter() - t0)
            hist = {f"{1 << ((c >> 4) & 15)}x{1 << (c & 15)}"
                    f"{'m' if c >> 16 else 'b'}": int(n)
                    for n, c in zip(o.classes[:, 2], o.classes[:, 3])}
            ftype = "P/B" if pf.refs else "I"
            log(f"  {label} frame {i} ({ftype}): {len(tus)} TUs in "
                f"{len(o.classes)} classes, {o.n_cta} CTAs, {o.smem} B "
                f"shared; itdq_order {min(t) * 1e3:.3f} ms (min of 20, "
                f"median {np.median(t) * 1e3:.3f}); TUs a class (w x h, "
                f"m Main, b Baseline): {hist}")
            args = ((df.coef_y, df.coef_u, df.coef_v), df.tus, pf.shp_y,
                    pf.shp_c, pf.bd, tab, pf.iqt)
            ms = run_case(torch, KernelCase(
                "itdq", f"{label} frame {i} ({ftype}), {len(tus)} TUs",
                lambda: TQ.itdq(*args, order=df.tu_order),
                lambda: TQ.itdq_ref(*args), *itdq_work(tus),
                reset=lambda: None), results, 10, 1, launches=ITDQ_LAUNCHES)
            if i == 0:
                results["itdq"][f"ms_{name}_frame0"] = ms
                results["itdq"][f"ms_device_{name}_frame0"] = \
                    results["itdq"]["last_device_ms"]


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
                 f"{df.level_off.shape[0] - 1} levels")
        run_case(torch, intra_wave_planes_case(
            dev, recs, resids, df.icu, df.level_off, pf.bd, pf.chroma,
            shape), results, 5, 0, main=i == 0)


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


def start_gop_worker(g):
    """Start GOP g's workers, one after the other: the reference worker
    generates the stream (tests/fixtures/torch_smoke_gop<g>.evc), then the
    port's host decoder captures it (WORK/gop<g>.pkl): the numpy oracle's
    serial decode, with each frame's pack.  (The capture is the serial
    oracle decode that decode_gops_sharded holds the batch to, so the
    reference worker does not decode it a second time: a 1080p GOP frame
    takes tens of CPU seconds to encode and to decode.)"""
    script = ('"$0" tests/torch_reference.py "$1" "$2" && '
              '"$0" -m xevd_tpu_torch.parallel.gop --capture "$2" "$3"')
    return subprocess.Popen(
        ["sh", "-c", script, sys.executable, json.dumps(GOP_SPECS[g]),
         str(STREAM_DIR / f"torch_smoke_gop{g}.evc"),
         str(WORK / f"gop{g}.pkl")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def start_streams_worker(specs, name):
    """Start the reference worker that writes the streams of `specs` to
    WORK/<name>/<g>.evc, all in one process (they are small)."""
    return subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_reference.py"),
         "--streams", json.dumps(specs), str(WORK / name)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


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
    intra_main_path(torch, dev, packed, results)
    deblock_main_path(torch, dev, packed["1080p_p"], results)
    itdq_main_path(torch, dev, packed, results)
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
    # MC launches a decode of each stream makes: one a list with rows
    mc_launches = {name: sum(int(n > 0) for pf in frames for n in pf.mc_lists)
                   for name, frames in packed.items()}
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
        if counts["mc"] != reps * mc_launches[name]:
            raise AssertionError(f"{name} path: {counts['mc']} MC launches, "
                                 f"{reps} x {mc_launches[name]} expected")
        runs[name] = (counts, fps, stage_ms)
    return runs


def device_ms(marks):
    """Device milliseconds between the stage marks of decodes (CUDA events;
    pack, host work, left out)."""
    return sum(marks[i - 1][1].elapsed_time(ev)
               for i, (stage, ev, _) in enumerate(marks)
               if stage not in ("start", "pack"))


def big_gop_phase(torch, dev, K, results, worker):
    """The GOP batch past 32 ring pictures: the BIG_GOP_SPECS GOPs,
    captured here (the numpy oracle's serial decode, through the port's
    host decoder), on one card: every batched kernel on step 1 against its
    batched plain version, MC in 10 launches; then the whole batch, every
    frame's MD5 equal to the oracle's.  Returns its stats."""
    from tests.torch_helpers import gop_step_cases
    from xevd_tpu_torch.parallel import gop as TG

    out, err = worker.communicate()
    if worker.returncode != 0:
        raise AssertionError(f"big GOP stream worker failed (rc "
                             f"{worker.returncode}):\n{err[-4000:]}")
    t0 = time.perf_counter()
    caps = [TG._capture_gop((WORK / "biggop" / f"{g}.evc").read_bytes())
            for g in range(len(BIG_GOP_SPECS))]
    log(f"phase gop past 32 ring pictures: {len(caps)} 64x64 two-frame "
        f"IPPP GOPs on one card; streams {json.loads(out)['gen_s']:.1f} s, "
        f"captures {time.perf_counter() - t0:.1f} s")
    for case in gop_step_cases(dev, caps):
        key = case.name if case.name == "gop_step" else f"gop_{case.name}"
        run_case(torch, case, results, 0, 0, key=key,
                 launches=10 if case.name == "mc" else None)
    stats = {}
    dmd5, smd5 = TG.decode_gops_sharded(None, mesh=[dev], captures=caps,
                                        stats=stats)
    ring = stats["depth"] * len(caps)
    if ring <= 32 or dmd5 != smd5 or \
            stats["checksum"] != stats["serial_checksum"]:
        raise AssertionError(f"GOP batch of {len(caps)} GOPs ({ring} ring "
                             "pictures): a frame's MD5 differs from the "
                             "numpy oracle's, or the ring holds <= 32")
    log(f"  {stats['frames']} frames in {stats['steps']} steps (batches "
        f"{stats['batches'][0]}, DPB depth {stats['depth']}: {ring} ring "
        f"pictures) in {stats['seconds'] * 1e3:.3f} ms; every MD5 equal to "
        "the numpy oracle's")
    return {"gops": len(caps), "ring_pictures": ring,
            "frames": stats["frames"], "ms": stats["seconds"] * 1e3}


def main_gop_phase(torch, dev, K, results, worker):
    """The GOP batch with the Main MC taps: the MAIN_GOP_SPECS GOPs,
    captured here, on one card: every batched kernel and the step on step
    1 against its batched plain version at G = 8 and G = 1 (the batched
    iqt/ATS ITDQ and Main-tap MC; MC in MC_LAUNCHES launches, timed);
    then the whole batch, every frame's MD5 equal to the oracle's.
    Returns its stats."""
    from tests.torch_helpers import gop_step_cases, mc_class_histogram
    from xevd_tpu_torch.ops import pack as PK
    from xevd_tpu_torch.parallel import gop as TG

    out, err = worker.communicate()
    if worker.returncode != 0:
        raise AssertionError(f"Main GOP stream worker failed (rc "
                             f"{worker.returncode}):\n{err[-4000:]}")
    t0 = time.perf_counter()
    caps = [TG._capture_gop((WORK / "maingop" / f"{g}.evc").read_bytes())
            for g in range(len(MAIN_GOP_SPECS))]
    if not all(fr["pack"].main_taps and fr["pack"].iqt for c in caps
               for fr in c):
        raise AssertionError("Main GOP batch: a frame without the Main taps "
                             "or iqt")
    log(f"phase gop with the Main taps: {len(caps)} 176x144 Main IPPP GOPs "
        f"({', '.join(MAIN_GOP_TOOLS)}); streams "
        f"{json.loads(out)['gen_s']:.1f} s, captures "
        f"{time.perf_counter() - t0:.1f} s")
    _, [(_, steps)] = TG._plan(caps, 1)
    o = PK.McOrder(None, PK._table(steps[1], "mc_cls", 4), steps[1].mc_launch)
    log(f"  step 1 MC rows a class: {mc_class_histogram(o)}")
    r = results.setdefault("gop_mc", {"max_abs_err": 0})
    for G in (len(caps), 1):
        for case in gop_step_cases(dev, caps[:G]):
            key = case.name if case.name == "gop_step" else f"gop_{case.name}"
            mc = case.name == "mc"
            ms = run_case(torch, case, results, 20 if mc else 0,
                          0, key=key, launches=MC_LAUNCHES if mc else None)
            if mc:
                r[f"ms_main_taps_g{G}"] = ms
                r[f"ms_device_main_taps_g{G}"] = r["last_device_ms"]
    stats = {}
    dmd5, smd5 = TG.decode_gops_sharded(None, mesh=[dev], captures=caps,
                                        stats=stats)
    if dmd5 != smd5 or stats["checksum"] != stats["serial_checksum"]:
        raise AssertionError("Main-tap GOP batch: a frame's MD5 differs "
                             "from the numpy oracle's")
    log(f"  {stats['frames']} frames in {stats['steps']} steps (batches "
        f"{stats['batches'][0]}) in {stats['seconds'] * 1e3:.3f} ms; every "
        "MD5 equal to the numpy oracle's")
    return {"gops": len(caps), "frames": stats["frames"],
            "ms": stats["seconds"] * 1e3}


def gop_phase(torch, dev, K, results, workers):
    """K15: the 8 1080p GOPs as one batch per time step (parallel/gop.py),
    after each batched kernel and the batched step against its plain
    version on step 1 at G = 8 and G = 1.  Returns (counts, frames/s per
    batched run, record)."""
    from tests.torch_helpers import gop_step_cases
    from xevd_tpu_torch import TorchPixelBackend
    from xevd_tpu_torch.parallel import gop as TG

    log("phase gop: 8 1080p Baseline IPPP GOPs (K15); streams and captures "
        "(the numpy oracle's serial decodes) in worker processes")
    caps = []
    for g, proc in enumerate(workers):
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"GOP {g} worker failed (rc "
                                 f"{proc.returncode}):\n{err[-4000:]}")
        ref, cap = [json.loads(x) for x in out.splitlines()
                    if x.startswith("{")][-2:]
        caps.append(pickle.loads((WORK / f"gop{g}.pkl").read_bytes()))
        if len(caps[-1]) != GOP_SPECS[g][2]:
            raise AssertionError(f"GOP {g}: {len(caps[-1])} frames captured, "
                                 f"{GOP_SPECS[g][2]} encoded")
        log(f"  GOP {g}: {len(caps[-1])} frames; stream {ref['gen_s']:.1f} "
            f"s, capture (numpy oracle) {cap['seconds']:.1f} s")

    # every worker has ended: the pad kernel again, on a quiet host
    from tests.torch_helpers import pad_case
    from xevd_tpu_torch.ops.tables import PAD_L
    log("phase pad again (no worker running)")
    results["pad"]["ms_after_workers"] = run_case(
        torch, pad_case(dev, 8, 1080, 1920, PAD_L, seed=210), {}, 50, 50)

    from tests.torch_helpers import mc_class_histogram
    from xevd_tpu_torch.ops import pack as PK
    _, [(_, steps)] = TG._plan(caps, 1)
    table = PK._table(steps[1], "mc", 10)
    t = []
    for _ in range(5):
        t0 = time.perf_counter()
        o = PK.mc_order(table, steps[1].mc_lists)
        t.append(time.perf_counter() - t0)
    log(f"  step 1 at G = {steps[1].G}: {len(table)} MC rows in "
        f"{len(o.classes)} classes, {o.lists[0][2]}+{o.lists[1][2]} CTAs; "
        f"mc_order {min(t) * 1e3:.3f} ms (min of 5); rows a class: "
        f"{mc_class_histogram(o)}")
    log("phase gop kernels (each batched kernel and the batched step on "
        "step 1, G = 8 and G = 1)")
    for G in (len(caps), 1):
        for case in gop_step_cases(dev, caps[:G]):
            key = case.name if case.name == "gop_step" else f"gop_{case.name}"
            slow = case.name in ("intra_scan", "gop_step")
            ms = run_case(torch, case, results, 5 if slow else 20,
                          0 if slow else 3, main=G > 1, key=key)
            if G == 1:
                results[key]["ms_g1"] = ms

    # launches a batched run must make: one a step for each kernel (a
    # plane each for recon, pad and the chroma passes), MC once per list
    expect = dict.fromkeys(K.launch_counts, 0)
    for pb in steps:
        expect["gop_step"] += 1
        expect["itdq"] += int(pb.layout["tus"][1][0] > 0)
        expect["mc"] += sum(int(n > 0) for n in pb.mc_lists)
        expect["recon"] += 3
        expect["intra_scan"] += int(pb.layout["icu"][1][0] > 0)
        expect["pad"] += 3
        for kind in ("luma_ver", "luma_hor", "chroma_ver", "chroma_hor"):
            expect[f"deblock_{kind}"] += pb.deblock_on * (
                1 if kind.startswith("luma") else 2)
    fps, counts, stats = [], None, None
    for rep in range(TIMED_RUNS_GOP):
        torch.cuda.synchronize()
        K.reset_counts()
        stats = {}
        dmd5, smd5 = TG.decode_gops_sharded(None, mesh=[dev], captures=caps,
                                            stats=stats)
        counts = dict(K.launch_counts)
        if dmd5 != smd5:
            raise AssertionError("GOP batch: a frame's MD5 differs from the "
                                 "numpy oracle's")
        if stats["checksum"] != stats["serial_checksum"]:
            raise AssertionError(f"GOP batch checksum {stats['checksum']} != "
                                 f"{stats['serial_checksum']}")
        if counts != expect or counts["intra_scan"] != stats["steps"]:
            raise AssertionError(f"GOP batch launches {counts} != {expect}")
        fps.append(stats["frames"] / stats["seconds"])
        log(f"  batched run {rep}: {stats['frames']} frames in "
            f"{stats['steps']} steps (batches {stats['batches'][0]}, DPB "
            f"depth {stats['depth']}) in {stats['seconds'] * 1e3:.3f} ms = "
            f"{fps[-1]:.3f} frames/s (uploads, kernels, output copies); "
            f"every MD5 equal to the numpy oracle; checksum "
            f"{stats['checksum']}")
    log(f"  launch counts during a batched run: {counts}")

    # the same GOPs serially, frame by frame, for the record
    marks = []

    def on_stage(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev, time.perf_counter()))

    backend = TorchPixelBackend(device=dev, on_stage=on_stage)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    outs = []
    for g in range(len(caps)):
        n += decode_to_yuv((STREAM_DIR / f"torch_smoke_gop{g}.evc")
                           .read_bytes(), backend, WORK / f"gop{g}_t.yuv")
        outs.append((WORK / f"gop{g}_t.yuv").read_bytes())
    w, h = GOP_SPECS[0][:2]
    fsz = w * h * 3                       # 4:2:0, 2 bytes a sample
    if [[hashlib.md5(y[i:i + fsz]).hexdigest() for i in range(0, len(y), fsz)]
            for y in outs] != smd5:
        raise AssertionError("GOP serial decode differs from the numpy oracle")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serial = {"frames": n, "fps": n / wall, "device_ms": device_ms(marks)}
    log(f"  serial TorchPixelBackend('cuda') decode of the 8 GOPs: {n} "
        f"frames in {wall:.4f} s = {serial['fps']:.3f} frames/s (host "
        f"entropy + pack + device + 10-bit write); device stages "
        f"{serial['device_ms']:.3f} ms in all, batched step "
        f"{stats['seconds'] * 1e3:.3f} ms")
    return counts, fps, {"batched": stats, "serial": serial}


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
    # the GOP workers first: theirs is the longest host work
    gop_workers = [start_gop_worker(g) for g in range(len(GOP_SPECS))]
    big_gop_worker = start_streams_worker(BIG_GOP_SPECS, "biggop")
    main_gop_worker = start_streams_worker(MAIN_GOP_SPECS, "maingop")
    prepared = {name: start_reference(name) for name in STREAMS}
    try:
        K.build(verbose=True)      # always from this checkout's sources
        K.lib()
        log(f"build: nvcc {K.build_seconds:.1f} s, one process a source "
            f"({', '.join(K.SOURCES)} -> {K.BUILD_DIR.relative_to(REPO)})")

        results = {}
        kernel_phases(torch, dev, results)
        runs = slice_phase(torch, dev, K, results, prepared)
        runs["gop"] = gop_phase(torch, dev, K, results, gop_workers)
        big_gop = big_gop_phase(torch, dev, K, results, big_gop_worker)
        main_gop = main_gop_phase(torch, dev, K, results, main_gop_worker)
    finally:
        for p in (list(prepared.values()) + gop_workers
                  + [big_gop_worker, main_gop_worker]):
            if p.poll() is None:
                p.kill()
            p.communicate()

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = results[name]
        t_bytes = r["bytes"] / HBM_BYTES_PER_S
        t_ops = r["ops"] / SCALAR_OPS_PER_S
        counter = name[4:] if name in (f"gop_{k}" for k in GOP_KERNELS) \
            else name
        extra = {k: r[k] for k in r if k.startswith(("ms_", "library_"))
                 and k != "library_ms"}
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces,
                        "launches": runs[PATH_OF.get(name, MAIN_PATH)][0][
                            counter],
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": max(t_bytes, t_ops) * 1e3,
                        "bound_by": "bytes" if t_bytes >= t_ops
                        else "operations",
                        # F.pad(mode="replicate") for K14 where CUDA
                        # takes int16; no single PyTorch call computes the
                        # other integer pipelines (PERF.md)
                        "library_ms": r.get("library_ms"),
                        "shape": r["shape"], **extra})
    for key, shape, ms, plain_ms in SCANS:
        log(f"scan {key}: {shape}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.2f} ms, each of {SCAN_LAUNCHES} launches equal")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"persistent grids on {sms} SMs: intra_scan "
        f"{K.persistent_grid('xevd_intra_scan')} CTAs, intra_scan_wave "
        f"{K.persistent_grid('xevd_intra_scan_wave')} CTAs")
    for name, (_, fps, stage_ms) in runs.items():
        log(f"slice {name}: frames/s {[round(f, 3) for f in fps]}; "
            f"{'record' if name == 'gop' else 'stage ms/frame'} "
            f"{json.dumps(stage_ms, default=str)}")
    log(f"GOP batch past 32 ring pictures: {json.dumps(big_gop)}")
    log(f"GOP batch with the Main taps: {json.dumps(main_gop)}")
    log(f"total smoke time {time.perf_counter() - t_start:.1f} s")
    log(gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
