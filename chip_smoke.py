#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (xevd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), torch/CUDA versions
   and which entropy engine runs; exits non-zero without a CUDA device.
   Starts, each as a program of its own, the captures of the committed
   4K and 1080p GOP streams (`python -m xevd_tpu_torch.parallel.gop
   --capture`: the numpy oracle's serial decode with each frame's pack),
   and (tests/torch_reference.py) the generation of the nine test streams
   (tools/evc_enc, seeded) and their decodes by `xevd_tpu`'s numpy oracle
   backend, the reference.
2. Builds the CUDA kernels from xevd_tpu_torch/csrc with nvcc (sm_90a).
3. Kernel phases: every hand-written kernel against its plain PyTorch
   version on the card, on numpy-seeded inputs at the shapes of the 1080p
   main paths, with exact equality (integer kernels, tolerance 0), and both
   times: ITDQ Baseline, Main iqt and every ATS basis pair; MC on a frame of
   every class of its kernel (plane group, size, case; windows at the
   planes' edges, phase 0 under filtering cases, split 64x64 blocks) at 8
   and 10 bit with the Baseline and the Main taps, 10 launches a case, with
   the Baseline and the Main taps at every (plane, case, bit depth) and on a
   synthetic 1080p frame; recon, pad-expand (one launch a picture over Y,
   U and V: a config-3-sized picture, an odd pitch, 4:0:0, a GOP batch
   step of 8 and of 1 picture; beside torch.nn.functional.pad(mode=
   "replicate"), its library yardstick, three calls a picture, or CUDA's
   refusal of int16), deblock (K8, both luma passes in one launch, on
   1080p areas with random maps, every edge at strength 12, no edge,
   vertical or horizontal edges only and a GOP batch of 8, and the
   single-pass API; 20 launches a case), the SUCO-order chroma deblock
   (K10: random lists, every edge on, one long run, repeated edges, empty
   rows; 20 launches a case), ADDB on whole 1080p pictures (one launch
   over Y, U and V: random maps, bs 4 everywhere, no edge, 4:0:0, an
   unaligned pitch) and ALF on whole 1080p
   pictures (one launch: CTU 64 and 128, across tiles or not, an unaligned
   pitch), 10 launches a case; ITDQ on a frame of every size class (2x2 to
   64x64, square and rectangular, Baseline beside ATS and all Main, and at
   the largest scale with coefficients over the whole int16 range), 10
   launches a case; K9 (the Baseline chroma deblock cascade) on random maps,
   maps with every edge on and an empty one at 8 and 10 bit, 20 launches a
   case; the Baseline intra scan on CIF with random causal CU lists and on
   4x4 CUs with every causal bit set, and the EIPD wavefront scan with HTDF
   on CIF with random CU lists (step 4 holds the scans, MC, the SUCO order,
   ADDB and ALF to their plain versions on the streams' own frames). The two
   scans are persistent dataflow kernels: each of their cases, here and in
   steps 4 and 5, runs the plain version once and the kernel 20 times from
   the same inputs, every launch equal (a race shows as a difference between
   launches).  Then the graft entry's step (xevd_tpu_torch/entry.py: ITDQ,
   recon and K8 on a 128x128 picture, one launch each) on the card, equal
   to its plain versions' on the CPU.
4. Slice phase: nine streams are decoded with Decoder(backend=
   TorchPixelBackend("cuda")); each 10-bit YUV must equal the numpy
   oracle's: 1920x1080 Baseline all-intra (2 frames), 352x288 10-bit
   all-intra (4), 1920x1080 Baseline IPPP (4: bench.py's config-2 stream cut
   from 16 frames), 352x288 10-bit RA (5, bi-prediction), 1920x1080 Main RA
   with bench.py's 14 config-3 tools (5 pictures: config 3 cut from 9 frames
   to 3), the same 1080p Main RA stream with 12 tools, SUCO without ADDB and
   ALF (the SUCO-order chroma deblock path), and with 11 tools, without
   SUCO, ADDB and ALF (the raster Baseline deblock on the Main path), and
   352x288 10-bit Main IPPP with DRA, iqt, ATS and HTDF (4), once with ADDB
   and ALF and once without (the Baseline deblock at 10 bit). The Baseline
   intra scan kernel is held to its plain version on every 1080p intra
   frame's own CU table and planes and on the 1080p IPPP stream's P frame
   with the most intra CUs, K8 and K9 on every IPPP frame's own luma and
   chroma areas and maps (20 launches each; the edges of each luma map and
   the run lengths of each chroma map printed), ITDQ on
   every config-3 and IPPP frame's own TU table (10 launches; the TUs of
   each size class and the host time of the class grouping printed), the MC
   kernel on every 1080p P frame's own block table and class order and on
   the config-3 stream's B pictures (Main taps; 10 launches each; the rows
   of each class and the host time of `mc_order` printed), the EIPD scan
   kernel on its I picture and one B picture, the SUCO order on the SUCO
   stream's pictures, ADDB and ALF on every config-3 and CIF 10-bit Main
   picture (10 launches each; ALF also on the first config-3 picture's luma
   alone and one chroma plane alone), K10 in 20 launches a picture (each
   picture's longest run printed beside its longest row list). The CLI
   entry point decodes the CIF RA and both CIF Main streams. Six paths
   are counted and timed: the 1080p all-intra decode once, the 1080p IPPP decode twice, the 11-tool Main
   stream, the CIF 10-bit Main stream without ADDB and ALF and the SUCO
   stream once each, and the config-3 stream (the main path) three times;
   the launch counters are reset just before each path and read just after
   it; every kernel the path needs must have launched, and none it must not;
   MC once a reference list with blocks, per frame; ADDB once a picture that
   has it, ALF once a picture that filters any plane, the luma deblock
   (K8) once a picture with the Baseline deblock, pad once a
   picture. Each counted decode prints its frames/s and per-stage
   CUDA-event times, with the H2D copies' events apart.
   Staging phase (ops/staging.py): the config-3 and 1080p IPPP streams
   again, first with torch.cuda.set_sync_debug_mode("error") around each
   `TorchPixelBackend.decode_frame` (any synchronising call in it
   raises), then at ring depth 2 with a long torch.cuda._sleep before
   each frame's copies (the pack two frames later finds its slot's copies
   queued: the ring must wait at least once); each output equal to the
   numpy oracle.
   Config-4 phase (BASELINE.json configs[3], Main 4K 10-bit): the
   committed 3840x2160 10-bit Main RA stream with config 3's 14 tools and
   DRA (xevd_tpu_torch/streams/c4.evc, 5 pictures; bench.py CONFIGS["c4"])
   decoded once through Decoder + TorchPixelBackend("cuda") with the
   launch counters: every kernel of the main path's list launched (ITDQ,
   recon, pad, MC, the EIPD scan, ADDB, ALF: MC once a list with blocks,
   ADDB, ALF and pad once a picture that has them) and none of the
   Baseline intra scan, K10 and the Baseline deblock; every frame's MD5
   equal to the committed numpy-oracle MD5 (c4.json).  Prints each
   picture's stage ms (the I picture's intra stage is K6 with K7),
   torch.cuda.max_memory_allocated() and the kernel table's 4K column: each
   kernel of the path on the I picture and on the B picture with the most
   MC blocks, on the inputs the path handed it, held to its plain version
   there (exact; K6 in 5 launches) and timed by CUDA-graph replays beside
   its bound.  K6's plain version runs on the B picture alone (on the I
   picture it takes some 2 minutes): there its 5 launches are held to each
   other and the frame MD5s hold the result.  Fails past 90 s.
   Stage-diff phase: `python -m xevd_tpu_torch.diff --stages`'s
   function on the card against the numpy oracle's processes (one a
   knock-out): the CIF 10-bit Main stream with ADDB and ALF agrees under
   every knock-out, and the CIF 10-bit intra stream with one chroma
   vertical strength raised on the port's side agrees only with
   deblocking off and under `nover`.
5. GOP phase (K15, xevd_tpu_torch/parallel/gop.py): 8 independent
   1920x1080 Baseline IPPP GOPs of 2, 3 or 4 frames (xevd_tpu/parallel/
   gop.py `gen_gop_streams(8, 1920, 1080, frames=2, variable=True)`'s
   encoder settings; bench.GOP_SPECS), committed with the numpy oracle's
   MD5s (xevd_tpu_torch/streams/gop_<g>.evc, gop.json) and each captured
   (decoded serially by the numpy oracle backend, each frame's pack kept)
   by the port's host decoder in a worker (`python -m
   xevd_tpu_torch.parallel.gop --capture`).  Every batched
   kernel, and the whole batched step, is held to its batched plain
   version on the batch's own step-1 (P) tables and DPB at G = 8 and G =
   1, and on step 0 (the 8 I pictures: no MC) at G = 8 and G = 1 (the
   intra scan's and the step's plain versions, a tensor operation a CU,
   on copies of the same inputs on the CPU, 2-2.4x faster there); step
   0's batched intra scan, whose rows the pack's ticket order interleaves
   over the frames, is timed beside each of its pictures scanned alone
   (the same kernel at G = 1) with the batch's DAG depth, and must take
   at most 3x the slowest; then all 8 GOPs decode as one batch per time
   step on the card
   (counted: each batched kernel once a step, the intra scan once a step,
   not once a frame; the luma deblock one launch a step; pad one launch a
   step over Y, U and V), twice, and
   every frame's MD5 must equal the numpy oracle's serial decode (the
   capture's and the committed MD5s), then
   once more with each step's split printed (the copy into its pinned
   slot, the issue of its copies, the copies on the upload stream, the
   kernel stream's wait, the kernels and each of their stages -- ITDQ,
   MC, recon, intra, deblock, pad -- the output copies); the
   same 8 GOPs then decode serially through Decoder +
   TorchPixelBackend("cuda"), equal too, for the record.  The
   pad kernel (K14) is timed a second time, on a 1080p picture, once every
   worker has ended.
   Config 5's one-card half (gop4k phase, BASELINE.json configs[4]): the
   8 committed 3840x2160 10-bit Main IPPP GOPs of 2 or 3 frames with iqt,
   ATS, ADMVP and cm_init (bench.GOP4K_SPECS; streams/gop4k_<g>.evc,
   gop4k.json; 20 pictures in 3 steps), captured in workers started
   first, decode as one batch a step with the launch counters (each
   batched kernel once a step, MC on steps 1 and 2, none of ADDB, ALF,
   K6, K10), every MD5 equal to the capture's and the committed oracle
   MD5s; the peak device memory and the pinned host buffers printed; a
   second decode prints the step split; step 0's batched scan (8 4K I
   pictures) held to its own 20 launches (its plain version takes
   minutes) with its device ms, DAG depth and `icu_order`'s host ms; the
   4K column: every batched kernel and the batched step on step 1 at G =
   8 held to its plain version (exact; the scan's and the step's plain
   versions on the CPU), with device ms, a call in 20-call graphs and the
   bound.  Fails past GOP4K_LIMIT_S (the captures not counted).
   Then forty 64x64 two-frame IPPP GOPs (one reference worker writes the
   streams; captured here) decode as one batch on the card, 40 DPB ring
   pictures (more than a frame's 32 MC slots): every batched kernel held
   to its plain version on step 1 (MC in 10 launches), every frame's MD5
   equal to the oracle's.  Last, eight 176x144 Main IPPP GOPs with iqt,
   ATS, ADMVP and cm_init (the batched Main-tap MC; one reference worker
   writes the streams; captured here): every batched kernel held on step
   1 at G = 8 and G = 1 (MC in 10 launches, timed), every MD5 of the
   batch equal to the oracle's.
6. Bench phase, once every worker has ended: the benchmark's functions
   (xevd_tpu_torch/bench.py) with two timed runs on the 1080p IPPP and
   config-3 streams (its configs 2 and 3, cut as above) and the 8 1080p
   GOPs, every decode held to the oracle's frame MD5s; bench.py's keys are
   checked and the report logged with the phase's seconds.
7. Prints each scan case's time with the DAG depth (K5) or level count
   (K6) of its frame and the persistent grids, then {"kernels": [...]}
   (launches from the config-3 path; the Baseline intra scan's and
   deblock's from the IPPP path, the SUCO order's from the SUCO path, the
   batched kernels' (gop_*) and K15's from the GOP path; each kernel's
   bound from its main case's bytes and operations; every kernel also
   with `ms_device`, its time from CUDA-graph replays without the
   wrapper's host work; K9 with `ms_all` / `ms_zero` for the maps with
   every edge on and none; every kernel but the two persistent scans and
   K15's step with `ms_device_per_call`, a call's time in graphs of 20
   calls (a one-call graph lasts at least the host's launch of the graph);
   ALF with `ms_device_luma` /
   `ms_device_chroma` (and their `_per_call`), its device time on one
   picture's luma alone and one chroma plane alone (ALF's phase lines
   also give the bytes of the unflagged luma CTUs it copies); K14 and
   `gop_pad` with `library_ms` and `library_ms_device`, F.pad's times on
   the same planes (three calls), or `library_refused`; `gop_intra_scan`
   and `gop_step` with `ms_step0` and `ms_device_step0`, their times on
   step 0, and `gop_intra_scan` with `depth_step0` and
   `ms_device_step0_alone(_max)`, step 0's DAG depth and its pictures'
   scans alone; the config-4 path's kernels with `c4_launches` (the 5
   pictures' launches) and `c4_ms_device_i` / `_b`, `c4_stage_ms_i` /
   `_b`, `c4_bound_ms_i` / `_b` and `c4_plain_ms_i` / `_b`, their 4K
   column on its I and B picture; the batched kernels and K15's step
   with `gop4k_launches`, `gop4k_ms_device` (`_per_call`), `gop4k_bound_ms`
   and `gop4k_plain_ms`, their 4K column on step 1 of the gop4k batch,
   `gop_intra_scan` with `gop4k_ms_device_step0`, and `gop_step` with
   `gop4k_fps`, `gop4k_peak_bytes` and `gop4k_pinned_bytes`;
   `max_abs_err` covers the 4K comparisons too), the smoke's total time
   and, as the last line, {"ok": true, "device": {...}}.

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
# the GOP batches (K15) whose streams are committed: bench.GOPS, "gop" the
# 8 1080p Baseline IPPP GOPs (bench.GOP_SPECS), "gop4k" config 5's one-card
# half (bench.GOP4K_SPECS); their captures run in worker processes
TIMED_RUNS_GOP = 2
# the GOP batch past 32 DPB ring pictures: forty two-frame 64x64 IPPP GOPs
# on one card (D x G_dev = 40), generated by one reference worker
BIG_GOP_SPECS = [(64, 64, 2, 30, 3000 + 7 * g, "IPPP", 0.5, 8, 0, (), 0.35)
                 for g in range(40)]


def main_gop_specs() -> list:
    """The GOP batch with the Main MC taps: eight 176x144 Main IPPP GOPs of
    2, 3 or 4 frames with bench.MAIN_GOP_TOOLS (iqt, ATS, ADMVP, cm_init:
    batched iqt/ATS ITDQ and Main-tap MC), generated by one reference
    worker."""
    from xevd_tpu_torch import bench as B
    return [(176, 144, 2 + g % 3, 30, 1200 + 7 * g, "IPPP", 0.5, 8, 1,
             B.MAIN_GOP_TOOLS, 0.35) for g in range(8)]


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
    "pad": ("cuda", "xevd_tpu_torch/csrc/pad.cu",
            "xevd_tpu/ops/pipeline.py:241"),
    "intra_scan": ("cuda", "xevd_tpu_torch/csrc/intra.cu",
                   "xevd_tpu/ops/jax_intra.py:113"),
    # K8: `luma_ver_pass` (:60) and `luma_hor_pass` (:78) in one kernel
    "deblock_luma": ("cuda", "xevd_tpu_torch/csrc/deblock.cu",
                     "xevd_tpu/ops/jax_deblock.py:60"),
    "deblock_chroma_ver": ("cuda", "xevd_tpu_torch/csrc/deblock.cu",
                           "xevd_tpu/ops/jax_deblock.py:96"),
    "deblock_chroma_hor": ("cuda", "xevd_tpu_torch/csrc/deblock.cu",
                           "xevd_tpu/ops/jax_deblock.py:170"),
    "mc": ("cuda", "xevd_tpu_torch/csrc/mc.cu",
           "xevd_tpu/ops/jax_mc.py:50"),
    "chroma_ver_ordered": ("cuda", "xevd_tpu_torch/csrc/deblock.cu",
                           "xevd_tpu/ops/jax_deblock.py:123"),
    "addb_frame": ("cuda", "xevd_tpu_torch/csrc/addb.cu",
                   "xevd_tpu/ops/jax_deblock.py:200"),
    "alf_frame": ("cuda", "xevd_tpu_torch/csrc/alf.cu",
                  "xevd_tpu/ops/jax_alf.py:150"),
}
# the batched kernels of the GOP path (K15), "gop_" + their counter name,
# and K15's step itself
GOP_KERNELS = ("itdq", "mc", "recon", "intra_scan", "deblock_luma",
               "deblock_chroma_ver", "deblock_chroma_hor", "pad")
KERNELS.update({f"gop_{k}": KERNELS[k] for k in GOP_KERNELS})
KERNELS["gop_step"] = ("cuda", "xevd_tpu_torch/parallel/gop.py",
                       "xevd_tpu/parallel/gop.py:197")
# the counted path whose launches the kernels line reports, where it is
# not the main path (the config-3 stream, whose deblock is ADDB)
PATH_OF = {"intra_scan": "1080p_p", "deblock_luma": "1080p_p",
           "deblock_chroma_ver": "1080p_p", "deblock_chroma_hor": "1080p_p",
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


SCAN_LAUNCHES = 20     # race check of each scan case (persistent kernels)
SCAN_NAMES = ("intra_scan", "intra_scan_wave")
SCANS = []             # (key, shape, kernel ms, plain ms) of each scan case
K9_LAUNCHES = 20       # each K9 and K10 case: launches equal to the plain
#                        version
ITDQ_LAUNCHES = 10     # each ITDQ class case
MC_LAUNCHES = 10       # each MC class-mix case and stream table
FRAME_LAUNCHES = 10    # each ADDB and ALF case (one launch a picture)


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
    from tests.torch_mc_times import graph_ms
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
    # and a call's time in graphs of case.graph_calls calls, where set
    pcs = (graph_ms(torch, case.kernel, reps, case.graph_calls)
           if reps and case.graph_calls > 1 else None)
    plain_ms = (timed(torch, case.plain, plain_reps) if plain_reps
                else t0.elapsed_time(t1))
    r = results.setdefault(key or case.name, {"max_abs_err": 0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["last_device_ms"] = dms
    r["last_device_ms_per_call"] = pcs
    if main:
        r.update(ms=ms, plain_ms=plain_ms, shape=case.shape,
                 bytes=case.bytes, ops=case.ops)
        if dms is not None:
            r["ms_device"] = dms
        if pcs is not None:
            r["ms_device_per_call"] = pcs
    timing = (f"kernel {ms:9.4f} ms  plain {plain_ms:10.4f} ms" if reps
              else "")
    if dms is not None:
        timing += f"  graph {dms:8.4f} ms"
    if pcs is not None:
        timing += f" ({pcs:.4f} a call of {case.graph_calls})"
    if case.copy_bytes:
        # the design's bytes beyond the function's (ALF: unflagged CTUs)
        timing += f"  copies {case.copy_bytes} B"
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
    from tests.torch_helpers import (CHROMA_MAPS, LUMA_MAPS,
                                     addb_synth_case, alf_synth_case,
                                     chroma_map, deblock_case,
                                     deblock_luma_case, intra_case,
                                     intra_chain_case, intra_wave_case,
                                     itdq_case, itdq_class_case,
                                     itdq_size_case, mc_case, mc_class_case,
                                     mc_size_case, pad_picture_case,
                                     recon_case, recon_pred_case, SUCO_LISTS,
                                     suco_case)
    from xevd_tpu_torch.ops.tables import BORDER, PAD_R

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

    log("phase recon/pad (pad: one launch a picture over Y, U and V)")
    for bd in (8, 10):
        run_case(torch, recon_case(dev, bd, BORDER + H + PAD_R,
                                   BORDER + W + PAD_R, seed=200),
                 results, 50, 50)
        run_case(torch, recon_pred_case(dev, bd, BORDER + H + PAD_R,
                                        BORDER + W + PAD_R, seed=230),
                 results, 50, 50, main=bd == 8)
        run_case(torch, pad_picture_case(dev, bd, 1080, 1920, seed=210),
                 results, 50, 50, main=bd == 8)
        for chroma, G, unaligned in ((True, None, True), (False, None, False),
                                     (True, 8, False), (True, 1, False)):
            run_case(torch, pad_picture_case(dev, bd, 1080, 1920, chroma, G,
                                             unaligned, seed=220),
                     results, 20 if G == 8 else 0, 0)
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

    log(f"phase deblock (K8: both luma passes in one launch on 1080p areas, "
        f"random maps, every edge at strength 12, no edge, ver or hor only, "
        f"a GOP batch of 8; the single-pass API; K9 on random maps; "
        f"{K9_LAUNCHES} launches a case)")
    for bd in (8, 10):
        r = results.setdefault("deblock_luma", {"max_abs_err": 0})
        for maps in LUMA_MAPS:
            run_case(torch, deblock_luma_case(dev, bd, 270, 480, seed=400,
                                              maps=maps),
                     results, 20, 1, main=bd == 8 and maps == "random",
                     launches=K9_LAUNCHES)
            if bd == 8:
                r[f"ms_device_{maps}"] = r["last_device_ms"]
                r[f"ms_device_{maps}_per_call"] = r["last_device_ms_per_call"]
        run_case(torch, deblock_luma_case(dev, bd, 270, 480, seed=430, G=8),
                 results, 20 if bd == 8 else 0, 0, launches=K9_LAUNCHES)
        if bd == 8:
            r["ms_device_g8"] = r["last_device_ms"]
            r["ms_device_g8_per_call"] = r["last_device_ms_per_call"]
        for kind in ("luma_ver", "luma_hor"):
            run_case(torch, deblock_case(dev, kind, bd, 270, 480, seed=400),
                     results, 20 if bd == 8 else 0, 1, launches=K9_LAUNCHES)
            if bd == 8:
                r[f"ms_device_{kind}"] = r["last_device_ms"]
                r[f"ms_device_{kind}_per_call"] = r["last_device_ms_per_call"]
        for kind in ("chroma_ver", "chroma_hor"):
            ms = run_case(torch, deblock_case(dev, kind, bd, 270, 480,
                                              seed=400),
                          results, 20, 3, main=bd == 8,
                          launches=K9_LAUNCHES)
            if bd == 8:
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

    log(f"phase chroma_ver_ordered (SUCO order; 1080p chroma; random lists, "
        f"every edge on, one long run, repeated edges, empty rows; "
        f"{K9_LAUNCHES} launches a case)")
    for bd in (8, 10):
        for kind in SUCO_LISTS:
            run_case(torch, suco_case(dev, bd, 270, 480, seed=600, kind=kind),
                     results, 20, 1 if kind == "random" else 0,
                     launches=K9_LAUNCHES)

    log(f"phase addb (1080p pictures, one launch each: Y, U and V; random "
        f"maps, bs 4 everywhere, no edge, 4:0:0, an unaligned pitch; "
        f"{FRAME_LAUNCHES} launches a case)")
    for bd in (8, 10):
        for maps, chroma, unaligned in (
                ("dense", True, False), ("strong", True, False),
                ("none", True, False), ("dense", False, False),
                ("dense", True, True)):
            run_case(torch, addb_synth_case(dev, bd, 1080, 1920, seed=650,
                                            chroma=chroma, maps=maps,
                                            unaligned=unaligned),
                     results, 20, 1, launches=FRAME_LAUNCHES)

    log(f"phase alf (1080p pictures, one launch each, CTU 64 and 128, "
        f"across tiles or not, an unaligned pitch; {FRAME_LAUNCHES} launches "
        f"a case)")
    for bd in (8, 10):
        for log2_ctu, across, unaligned in ((6, 1, False), (6, 0, False),
                                            (7, 1, False), (7, 0, False),
                                            (6, 0, True)):
            run_case(torch, alf_synth_case(dev, bd, 1080, 1920, log2_ctu,
                                           across, seed=700,
                                           unaligned=unaligned),
                     results, 20, 1, launches=FRAME_LAUNCHES)


def pad_library(torch, dev, results):
    """K14's yardstick: torch.nn.functional.pad(mode="replicate"), the
    PyTorch call that computes `_pad_out`'s jnp.pad(mode="edge"), once a
    plane on the planes of the main pad case (a 1080p 4:2:0 picture: three
    calls) and of a GOP batch step of 8 such pictures (`gop_pad`); each
    equal to the kernel's output, timed by events and by graph replays; or
    CUDA's refusal of int16, recorded."""
    from tests.torch_helpers import picture_areas
    from tests.torch_mc_times import graph_ms
    from xevd_tpu_torch.ops import recon as TR
    from xevd_tpu_torch.ops.tables import PAD_C, PAD_L

    h, w = 1080, 1920
    for key, G in (("pad", None), ("gop_pad", 8)):
        areas = picture_areas(dev, 8, h, w, True, G, seed=210)
        crops = [(h, w, PAD_L), (h >> 1, w >> 1, PAD_C), (h >> 1, w >> 1,
                                                          PAD_C)]
        r = results.setdefault(key, {"max_abs_err": 0})

        def call():
            # [1, H, W] (C, H, W) or [G, 1, H, W]: the last two dims padded
            return [torch.nn.functional.pad(
                a[..., :ch, :cw][None] if G is None
                else a[:, None, :ch, :cw], (p,) * 4, mode="replicate")
                for a, (ch, cw, p) in zip(areas, crops)]
        what = f"{f'G {G} x ' if G else ''}{h}x{w} 4:2:0"
        try:
            got = call()
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as e:
            r["library_refused"] = str(e).strip().splitlines()[0]
            log(f"  F.pad(mode='replicate') on int16 {what}: refused: "
                f"{r['library_refused']}")
            continue
        want = TR.pad_picture(*areas, h, w, True)
        if not all(torch.equal(g.reshape(x.shape), x)
                   for g, x in zip(got, want)):
            raise AssertionError(f"F.pad(mode='replicate') != the pad "
                                 f"kernel on {what}")
        r["library_ms"] = timed(torch, call, 50)
        r["library_ms_device"] = graph_ms(torch, call, 100)
        log(f"  F.pad(mode='replicate') on int16 {what}, a call a plane: "
            f"equal to the pad kernel; {r['library_ms']:.4f} ms, graph "
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
    """K8 and K9 against their plain versions on the 1080p IPPP stream's
    own frames: the luma and chroma areas before deblock and the strength
    maps the path hands the kernels, K9_LAUNCHES launches each (the I
    frame's U plane is K9's summary case); the I frame's chroma maps also
    on 10-bit planes.  Prints each luma map pair's shifted blocks with a
    strength and each chroma map's run lengths (consecutive edges with a
    strength)."""
    import numpy as np
    from tests.torch_helpers import (deblock_area_case, deblock_case,
                                     deblock_luma_area_case,
                                     frame_areas_before, run_lengths)

    log("phase K8, K9 (1080p IPPP frames' own luma and chroma areas and "
        "maps)")
    r = results.setdefault("deblock_luma", {"max_abs_err": 0})
    for i, pf in enumerate(packed):
        areas, df = frame_areas_before(pf, dev, "deblock")
        ftype = "P" if pf.refs else "I"
        on = [(df.dbst[k] > 0).cpu().numpy() for k in (0, 1)]
        shape = (f"1080p IPPP frame {i} ({ftype}) Y "
                 f"{tuple(areas[0].shape)}, edges ver {int(on[0].sum())} "
                 f"hor {int(on[1].sum())} (of {on[0].size} SCUs)")
        run_case(torch, deblock_luma_area_case(dev, areas[0], df.dbst[0],
                                               df.dbst[1], pf.bd, shape),
                 results, 20, 1, launches=K9_LAUNCHES)
        if f"ms_device_ippp_{ftype}" not in r:
            r[f"ms_device_ippp_{ftype}"] = r["last_device_ms"]
            r[f"ms_device_ippp_{ftype}_per_call"] = r[
                "last_device_ms_per_call"]
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
FRAME_KERNELS = ("addb_frame", "alf_frame")


def alf_runs(pf) -> bool:
    """Whether ALF launches on a packed picture: ALF on, on a plane the
    picture has."""
    return pf.alf is not None and bool(
        pf.alf[0][0] or (pf.chroma and (pf.alf[0][1] or pf.alf[0][2])))


def frame_main_path(torch, dev, packed, results, label, kernels, main):
    """The SUCO-order chroma deblock, ADDB and ALF against their plain
    versions on a stream's own pictures: the areas, edge tables, parameter
    maps, coefficients and CTU flags the main path hands them (each picture
    run through the path's own stages up to that kernel), ADDB and ALF in
    FRAME_LAUNCHES launches each, K10 in K9_LAUNCHES.  `kernels` names the
    kernels to hold,
    each of which some picture must run; `main` marks the times of the
    picture with the most work (bytes) as the summary's, with ALF also
    timed on the first picture's luma alone and on one chroma plane
    alone."""
    from tests.torch_helpers import (addb_frame_case, alf_frame_case,
                                     frame_areas_before, suco_planes_case)

    log(f"phase {', '.join(kernels)} ({label} pictures)")
    cases, alf_parts = [], []
    for i, pf in enumerate(packed):
        if "chroma_ver_ordered" in kernels and pf.suco:
            (_, u, v), df = frame_areas_before(pf, dev, "deblock")
            row = int((df.suco_off[1:] - df.suco_off[:-1]).max())
            off = df.suco_runs.run_off
            run = int((off[1:] - off[:-1]).max())
            log(f"  {label} picture {i}: {df.suco_edges.shape[0]} edges in "
                f"{off.shape[0] - 1} runs; longest run {run}, longest row "
                f"list {row}")
            cases.append(suco_planes_case(
                dev, u, v, df.suco_off, df.suco_edges, pf.bd,
                f"{label} picture {i}, {df.suco_edges.shape[0]} edges, "
                f"longest run {run} (row {row})", runs=df.suco_runs))
        if "addb_frame" in kernels and pf.addb:
            areas, df = frame_areas_before(pf, dev, "deblock")
            cases.append(addb_frame_case(
                dev, areas, df.addb_l, df.addb_c, pf.bd,
                f"{label} picture {i}, {areas[0].shape[1]}x"
                f"{areas[0].shape[0]}{'' if pf.chroma else ' 4:0:0'}"))
        if "alf_frame" in kernels and alf_runs(pf):
            areas, df = frame_areas_before(pf, dev, "alf")
            (en, log2_ctu, across), (h, w) = pf.alf, pf.geom[:2]

            def case(enables, what):
                return alf_frame_case(
                    dev, areas, df.alf_l, df.alf_c, df.alf_on, h, w,
                    (enables, log2_ctu, across), pf.bd,
                    f"{label} picture {i}, {what}, CTU {1 << log2_ctu}")
            cases.append(case(en, "planes " + "".join(
                "YUV"[p] for p in range(3 if pf.chroma else 1) if en[p])))
            # the first picture with luma ALF also with its luma alone, the
            # first with chroma ALF with one chroma plane alone (the device
            # times of the parts)
            parts = {part for part, _ in alf_parts}
            if main and en[0] and "luma" not in parts:
                alf_parts.append(("luma", case((True, False, False),
                                               "Y alone")))
            for p in (1, 2):
                if main and pf.chroma and en[p] and "chroma" not in parts:
                    alf_parts.append(("chroma", case(
                        (False, p == 1, p == 2), f"{'YUV'[p]} alone")))
                    break
    missing = set(kernels) - {c.name for c in cases}
    if missing:
        raise AssertionError(f"{label}: no picture runs {missing}")
    best = {}
    for c in cases:
        if c.name not in best or c.bytes > best[c.name].bytes:
            best[c.name] = c
    for c in cases:
        launches = (FRAME_LAUNCHES if c.name in FRAME_KERNELS
                    else K9_LAUNCHES)
        run_case(torch, c, results, 10, 1, main=main and best[c.name] is c,
                 launches=launches)
    for part, c in alf_parts:
        run_case(torch, c, results, 10, 1, launches=FRAME_LAUNCHES)
        r = results["alf_frame"]
        r[f"ms_device_{part}"] = r["last_device_ms"]
        r[f"ms_device_{part}_per_call"] = r["last_device_ms_per_call"]


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


def start_captures(name) -> list:
    """Start the workers that capture the committed streams of GOP batch
    `name` (bench.gop_pair; encoding them takes minutes a GOP), one a GOP,
    into WORK/<name><g>.pkl: the numpy oracle's serial decode, with each
    frame's pack, by the port's host decoder (bench.capture_command).  The
    capture is the serial oracle decode that decode_gops_sharded holds the
    batch to."""
    from xevd_tpu_torch import bench as B
    return [subprocess.Popen(B.capture_command(evc, WORK / f"{name}{g}.pkl"),
                             cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for g, evc in enumerate(B.gop_pair(name)[0])]


def gather_captures(name, workers) -> tuple[list, list, list]:
    """Wait for GOP batch `name`'s capture workers: (the captures, the
    committed oracle MD5s a GOP, each capture's seconds).  Raises unless
    the committed spec is bench.GOPS[name] (bench.committed_gop_md5s) and
    each capture has as many frames as its GOP's MD5s."""
    from xevd_tpu_torch import bench as B
    md5s = B.committed_gop_md5s(name)
    caps, secs = [], []
    for g, proc in enumerate(workers):
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"{name} GOP {g} capture failed (rc "
                                 f"{proc.returncode}):\n{err[-4000:]}")
        secs.append(json.loads(out.strip().splitlines()[-1])["seconds"])
        caps.append(pickle.loads((WORK / f"{name}{g}.pkl").read_bytes()))
        if len(caps[-1]) != len(md5s[g]):
            raise AssertionError(f"{name} GOP {g}: {len(caps[-1])} frames "
                                 f"captured, {len(md5s[g])} committed MD5s")
    return caps, md5s, secs


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


# the stage marks timed by the host clock (ops/pipeline.py STAGES): the
# pack into a staging slot, and the upload, the issue of its two copies
# from the pinned slot (their device time: events before and after them)
HOST_STAGES = ("pack", "upload")
# torch.cuda._sleep cycles put on the stream before each frame's copies in
# the staging pressure phase: some 0.25 s at the H100's 1.98 GHz, several
# frames' host time, so a frame's copies are still queued when the pack
# two frames later asks for their slot
PRESSURE_SLEEP_CYCLES = 500_000_000


def counted_run(torch, K, backend, name, reps, marks, stages):
    """Decode stream `name` `reps` times through the main path with the
    launch counters reset just before; each run's output must equal the
    numpy backend's.  Returns (counts, frames/s per run, stage ms a frame
    of the last run)."""
    from xevd_tpu_torch.diff import port_decode
    path = STREAM_DIR / f"torch_smoke_{name}.evc"
    data = path.read_bytes()
    want = (WORK / f"{name}_np.yuv").read_bytes()
    runs = []
    torch.cuda.synchronize()
    K.reset_counts()
    for rep in range(reps):
        marks.clear()
        t0 = time.perf_counter()
        n = port_decode(data, WORK / f"{name}_t2.yuv", backend)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if (WORK / f"{name}_t2.yuv").read_bytes() != want:
            raise AssertionError(f"{name} timed run: output differs from "
                                 "numpy")
        stage_ms = {s: 0.0 for s in stages}
        h2d = 0.0
        for i, (stage, ev, t) in enumerate(marks):
            if stage == "start":
                continue
            _, prev_ev, prev_t = marks[i - 1]
            stage_ms[stage] += ((t - prev_t) * 1e3 if stage in HOST_STAGES
                                else prev_ev.elapsed_time(ev))
            if stage == "upload":
                h2d += prev_ev.elapsed_time(ev)
        stage_ms = {k: v / n for k, v in stage_ms.items()}
        device_ms = sum(v for k, v in stage_ms.items()
                        if k not in HOST_STAGES)
        stage_ms["h2d_events"] = h2d / n
        runs.append(n / wall)
        log(f"  {name} timed run {rep}: {n} frames in {wall:.4f} s = "
            f"{n / wall:.3f} frames/s (host entropy + pack + device + 10-bit "
            f"write); device stages {device_ms:.3f} of {wall * 1e3 / n:.3f} "
            f"ms a frame ({100 * device_ms * n / (wall * 1e3):.1f} %)")
        log("    per frame, ms (pack into the staging slot, upload: host "
            "clock, the upload the issue of its two copies from the pinned "
            "slot; h2d_events: the copies by CUDA events before and after "
            "them; others: CUDA events between stage marks): " +
            ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()))
    counts = dict(K.launch_counts)
    log(f"  launch counts during the {name} runs: {counts}")
    return counts, runs, stage_ms


def slice_phase(torch, dev, K, results, prepared):
    from xevd_tpu_torch import TorchPixelBackend
    from xevd_tpu_torch.app import main as app_main
    from xevd_tpu_torch.diff import port_decode
    from xevd_tpu_torch.ops.pipeline import STAGES

    class KeepingBackend(TorchPixelBackend):
        """Keeps each frame's host payload, to replay its kernels."""

        def __init__(self, device):
            super().__init__(device=device)
            self.packed = []

        def pack_frame(self, job, sps, refp):
            # the frame views a staging slot that later frames rewrite
            pf = super().pack_frame(job, sps, refp)
            self.packed.append(pf.copy())
            return pf

    log("phase slice: streams (numpy oracle decodes in worker processes)")
    packed = {}
    for name in STREAMS:
        n_np, t_gen, t_np = reference_result(prepared[name], name)
        path = STREAM_DIR / f"torch_smoke_{name}.evc"
        t0 = time.perf_counter()
        backend = KeepingBackend(dev)
        n_t = port_decode(path.read_bytes(), WORK / f"{name}_t.yuv",
                          backend)
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
                    FRAME_KERNELS, True)
    frame_main_path(torch, dev, packed["cif10_main_alf"], results,
                    "CIF 10-bit Main", FRAME_KERNELS, False)
    # MC launches a decode of each stream makes: one a list with rows
    mc_launches = {name: sum(int(n > 0) for pf in frames for n in pf.mc_lists)
                   for name, frames in packed.items()}
    # and ADDB's and ALF's: one a picture that has them; the Baseline luma
    # deblock's (K8, both passes): one a picture that has it; pad's: one a
    # picture
    frame_launches = {name: {"addb_frame": sum(pf.addb for pf in frames),
                             "alf_frame": sum(map(alf_runs, frames)),
                             "deblock_luma": sum(
                                 bool(pf.deblock_on and not pf.addb)
                                 for pf in frames),
                             "pad": len(frames)}
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
    baseline_db = ("deblock_luma", "deblock_chroma_ver", "deblock_chroma_hor")
    addb, alf = ("addb_frame",), ("alf_frame",)
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
                       "deblock_luma", "deblock_chroma_hor"),
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
        for k, n in frame_launches[name].items():
            if counts[k] != reps * n:
                raise AssertionError(f"{name} path: {counts[k]} {k} "
                                     f"launches, {reps} x {n} expected (one "
                                     f"a picture)")
        runs[name] = (counts, fps, stage_ms)
    return runs


# config 4 (BASELINE.json configs[3], Main 4K 10-bit): the committed
# 3840x2160 10-bit Main RA stream and its numpy-oracle MD5s
# (xevd_tpu_torch/streams/c4.evc, c4.json; bench.py CONFIGS["c4"]); the
# kernels its path needs and those it must not launch, as the main path's
C4_NEEDED = ("itdq", "recon", "pad", "mc", "intra_scan_wave", "addb_frame",
             "alf_frame")
C4_BARRED = ("intra_scan", "chroma_ver_ordered", "deblock_luma",
             "deblock_chroma_ver", "deblock_chroma_hor")
C4_LIMIT_S = 90          # the phase, its kernel column included
C4_GRAPH_REPS = 5        # graph replays a kernel in the 4K column
C4_SCAN_LAUNCHES = 5     # K6's launches on each 4K picture (race check)


def frame_stage_ms(marks):
    """Each frame's stage ms from `bench.StageMarks` marks ("start" opens a
    frame): the pack and the upload's issue by the host clock, the other
    stages by CUDA events between marks (h2d_events: the copies)."""
    frames, prev = [], None
    for name, ev, t in marks.marks:
        if name == "start":
            frames.append({})
        else:
            _, pev, pt = prev
            frames[-1][name] = ((t - pt) * 1e3 if name in HOST_STAGES
                                else pev.elapsed_time(ev))
            if name == "upload":
                frames[-1]["h2d_events"] = pev.elapsed_time(ev)
        prev = (name, ev, t)
    return frames


def c4_kernel_column(torch, dev, pf, label, scan_plain):
    """The 4K column of the kernel table on one kept picture of the config-4
    path: each kernel the path ran on it, on the inputs the path handed it
    (each stage's input made by the path's own kernels), held to its plain
    version on the same inputs (exact) and timed by C4_GRAPH_REPS one-call
    CUDA-graph replays; with its bytes and operations (tests/torch_helpers.py
    work functions) and bound.  K6 launches C4_SCAN_LAUNCHES times from the
    same inputs.  Without `scan_plain` (the I picture: plain K6 takes some 2
    minutes there) K6's plain version does not run: its launches are held
    to each other, and the frame MD5s hold the result.  Returns {kernel:
    {"ms_device", "plain_ms", "max_abs_err", "shape", "bytes", "ops",
    "bound_ms", "bound_by"}} ("plain_ms", "max_abs_err" None where the plain
    version did not run)."""
    from tests.torch_helpers import (KernelCase, addb_frame_case,
                                     alf_frame_case, frame_areas_before,
                                     intra_wave_planes_case, itdq_work,
                                     max_abs_err, mc_table_case,
                                     pad_areas_case, planes_before_intra,
                                     repeat_equal)
    from tests.torch_mc_times import graph_ms
    from xevd_tpu_torch.ops import itdq as TQ
    from xevd_tpu_torch.ops import recon as TR
    from xevd_tpu_torch.ops.tables import device_tables

    tab = device_tables(dev)
    h, w = pf.geom[:2]
    recs, resids, df = planes_before_intra(pf, dev)
    args = ((df.coef_y, df.coef_u, df.coef_v), df.tus, pf.shp_y, pf.shp_c,
            pf.bd, tab, pf.iqt)
    cases = [KernelCase("itdq", label,
                        lambda: TQ.itdq(*args, order=df.tu_order),
                        lambda: TQ.itdq_ref(*args), *itdq_work(df.tus))]
    preds = ((None, None),) * 3
    if pf.refs:
        mc = mc_table_case(dev, df.mc, pf.mc_lists, pf.refs, pf.shp_y,
                           pf.shp_c, pf.bd, label, pf.main_taps,
                           order=df.mc_order)
        cases.append(mc)
        p = mc.kernel()
        preds = ((p[0], p[1]), (p[2], p[4]), (p[3], p[4]))
    # recon: each plane's residual read and picture written (int16), with
    # the int32 prediction and int8 count read on an inter picture
    planes = [(r, q) for r, q in zip(resids, preds) if r is not None]
    cases.append(KernelCase(
        "recon", label,
        lambda: [TR.recon(r, pf.bd, *q) for r, q in planes],
        lambda: [TR.recon_ref(r, pf.bd, *q) for r, q in planes],
        sum(r.numel() * (4 if q[0] is None else 9) for r, q in planes),
        sum(r.numel() * (3 if q[0] is None else 5) for r, q in planes)))
    cases.append(intra_wave_planes_case(
        dev, recs, resids, df.icu, df.level_off, pf.bd, pf.chroma,
        f"{label}, {df.icu.shape[0]} CUs, {df.level_off.shape[0] - 1} "
        f"levels"))
    areas, dfd = frame_areas_before(pf, dev, "deblock")
    cases.append(addb_frame_case(dev, areas, dfd.addb_l, dfd.addb_c, pf.bd,
                                 label))
    if alf_runs(pf):
        areas, dfa = frame_areas_before(pf, dev, "alf")
        cases.append(alf_frame_case(dev, areas, dfa.alf_l, dfa.alf_c,
                                    dfa.alf_on, h, w, pf.alf, pf.bd, label))
    cases.append(pad_areas_case(dev, areas, h, w, pf.chroma, label))
    out = {}
    for c in cases:
        scan = c.name == "intra_scan_wave"
        got = c.kernel()
        if scan and not scan_plain:
            want, err, plain_ms = [None if t is None else t.clone()
                                   for t in got], None, None
        else:
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            want = c.plain()
            t1.record()
            torch.cuda.synchronize()
            err, plain_ms = max_abs_err(got, want), t0.elapsed_time(t1)
        if scan:
            e = repeat_equal(c, want, C4_SCAN_LAUNCHES - 1)
            if e:
                raise AssertionError(f"c4 {label}: K6's launches differ "
                                     f"(max abs err {e} over "
                                     f"{C4_SCAN_LAUNCHES} launches)")
        if err:
            raise AssertionError(f"c4 {label}: {c.name} != plain (max abs "
                                 f"err {err})")
        t_bytes = c.bytes / HBM_BYTES_PER_S
        t_ops = c.ops / SCALAR_OPS_PER_S
        out[c.name] = {"ms_device": graph_ms(torch, c.kernel, C4_GRAPH_REPS),
                       "plain_ms": plain_ms, "max_abs_err": err,
                       "shape": c.shape, "bytes": c.bytes, "ops": c.ops,
                       "bound_ms": max(t_bytes, t_ops) * 1e3,
                       "bound_by": "bytes" if t_bytes >= t_ops
                       else "operations"}
    return out


def c4_phase(torch, dev, K, results):
    """Config 4 on the card: the committed 3840x2160 10-bit Main RA stream
    (5 pictures) decoded once through Decoder + TorchPixelBackend("cuda")
    (the bench's decode: every output frame read to the host) with the
    launch counters reset just before and read just after: every kernel of
    C4_NEEDED launched and none of C4_BARRED, MC once a list with blocks,
    ADDB, ALF and pad once a picture that has them; every frame's MD5
    equal to the committed oracle MD5.  Prints each picture's stage ms
    (the I picture's intra stage is K6 with K7), the peak device memory
    and the kernel table's 4K column on the I picture and the B picture
    with the most MC blocks (`c4_kernel_column`: every kernel held to its
    plain version on both pictures, K6 on the B picture alone), and fails
    past C4_LIMIT_S."""
    from xevd_tpu_torch import TorchPixelBackend
    from xevd_tpu_torch import bench as B
    from xevd_tpu_torch.host.tables import SLICE_B, SLICE_I, SLICE_P

    t0 = time.perf_counter()
    evc, js = B.stream_pair("c4")
    rec = json.loads(js.read_text())
    if rec["spec"] != json.loads(json.dumps(B.CONFIGS["c4"])):
        raise AssertionError("the committed c4 pair's spec is not "
                             "bench.CONFIGS['c4']")
    w, h = rec["spec"][:2]
    pics = []          # (slice type, the frame's launches, kept pf)

    class C4Backend(TorchPixelBackend):
        def decode_frame(self, job, sps, refp):
            pics.append([job.fs.sh.slice_type])
            return super().decode_frame(job, sps, refp)

        def pack_frame(self, job, sps, refp):
            pf = super().pack_frame(job, sps, refp)
            pics[-1] += [{"mc": sum(int(n > 0) for n in pf.mc_lists),
                          "addb_frame": int(pf.addb),
                          "alf_frame": int(alf_runs(pf)), "pad": 1},
                         pf.copy()]
            return pf

    marks = B.StageMarks(dev)
    log(f"phase c4: {evc.relative_to(REPO)} ({evc.stat().st_size} B, "
        f"{w}x{h} 10-bit Main RA, {len(rec['md5s'])} frames, spec "
        f"{json.dumps(rec['spec'])})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)    # by earlier phases
    K.reset_counts()
    t1 = time.perf_counter()
    frames, host_s, engine = B.decode(evc.read_bytes(),
                                      C4Backend(dev, on_stage=marks))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = dict(K.launch_counts)
    peak = torch.cuda.max_memory_allocated(dev)
    B.check_frames(frames, rec["md5s"], "config 4")
    del frames
    missing = [k for k in C4_NEEDED if counts[k] == 0]
    stray = [k for k in C4_BARRED if counts[k]]
    want = {k: sum(p[1][k] for p in pics) for k in pics[0][1]}
    wrong = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
    if missing or stray or wrong:
        raise AssertionError(f"c4 path: kernels never launched {missing}, "
                             f"launched {stray}, or launches (counted, "
                             f"expected) {wrong} ({counts})")
    stage = frame_stage_ms(marks)
    if len(stage) != len(pics):
        raise AssertionError(f"c4: {len(stage)} marked frames, {len(pics)} "
                             "decoded")
    n = len(pics)
    log(f"  c4: {len(rec['md5s'])} frames, every MD5 equal to the committed "
        f"numpy-oracle MD5; {wall:.3f} s ({n / wall:.3f} frames/s, "
        f"host in Decoder.decode {host_s:.3f} s, entropy engine {engine}); "
        f"launches {counts}")
    kind = {SLICE_B: "B", SLICE_P: "P", SLICE_I: "I"}
    for i, (st, _, _) in enumerate(pics):
        log(f"  c4 picture {i} (decode order, {kind[st]}) stage ms: "
            + ", ".join(f"{k} {v:.3f}" for k, v in stage[i].items()))
    log(f"  c4 peak device memory: torch.cuda.max_memory_allocated() = "
        f"{peak} B ({peak / 2 ** 30:.3f} GiB), {held} B of it held before "
        f"the decode; the decode's own peak {peak - held} B")
    i_pic = next(i for i, p in enumerate(pics) if p[0] == SLICE_I)
    b_pic = max((i for i, p in enumerate(pics) if p[0] == SLICE_B),
                key=lambda i: sum(pics[i][2].mc_lists))
    log(f"  c4 I picture (decode order {i_pic}): intra stage (K6 with K7) "
        f"{stage[i_pic]['intra']:.3f} ms by events")
    decode_s = time.perf_counter() - t0
    column = {}
    for key, i in (("i", i_pic), ("b", b_pic)):
        pf = pics[i][2]
        col = c4_kernel_column(torch, dev, pf,
                               f"4K {key.upper()} picture {i}", key == "b")
        for name, r in col.items():
            column.setdefault(name, {})[key] = r
            how = (f"equal to plain ({r['plain_ms']:.1f} ms)"
                   if r["plain_ms"] is not None else
                   f"{C4_SCAN_LAUNCHES} launches equal, no plain")
            log(f"  c4 4K column, picture {i} ({key.upper()}): {name:16s} "
                f"{how}; device {r['ms_device']:.4f} ms (graph), stage "
                f"{stage[i].get(STAGE_OF[name], float('nan')):.4f} ms "
                f"(events), bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
                f"{r['bytes']} B); {r['shape']}")
    pics.clear()
    for name, c in column.items():
        r = results.setdefault(name, {"max_abs_err": 0})
        r["c4_launches"] = counts[name]
        for key, x in c.items():
            i = i_pic if key == "i" else b_pic
            r[f"c4_ms_device_{key}"] = x["ms_device"]
            r[f"c4_stage_ms_{key}"] = stage[i].get(STAGE_OF[name])
            r[f"c4_bound_ms_{key}"] = x["bound_ms"]
            r[f"c4_plain_ms_{key}"] = x["plain_ms"]
            if x["max_abs_err"] is not None:
                r["max_abs_err"] = max(r["max_abs_err"], x["max_abs_err"])
    seconds = time.perf_counter() - t0
    log(f"  c4 on {gpu_line()}: phase {seconds:.1f} s (decode and checks "
        f"{decode_s:.1f} s)")
    if seconds > C4_LIMIT_S:
        raise AssertionError(f"c4 phase took {seconds:.1f} s, over "
                             f"{C4_LIMIT_S} s")
    return {"frames": n, "fps": n / wall, "wall_s": wall,
            "peak_bytes": peak, "held_bytes": held, "counts": counts,
            "seconds": seconds}


# the pipeline stage (ops/pipeline.py STAGES) in which each kernel runs
STAGE_OF = {"itdq": "itdq", "mc": "mc", "recon": "recon",
            "intra_scan_wave": "intra", "addb_frame": "deblock",
            "alf_frame": "alf", "pad": "pad"}


def stage_diff_phase(dev):
    """The stage-diff tool (`python -m xevd_tpu_torch.diff --stages`) on
    the card against the numpy oracle's processes: the CIF 10-bit Main
    stream with ADDB and ALF must agree under every knock-out; the CIF
    10-bit intra stream with one chroma vertical strength raised on the
    port's side (`raise_chroma_ver_strength`) must agree only with
    deblocking off and under `nover`."""
    from tests.torch_helpers import raise_chroma_ver_strength
    from xevd_tpu_torch import diff as D

    t0 = time.perf_counter()
    for name, hook, agree in (
            ("cif10_main_alf", None, {"none", *D.KNOCKOUTS}),
            ("cif10_i", raise_chroma_ver_strength, {"nodb", "nover"})):
        w, h = STREAMS[name][:2]
        d = D.stage_diffs(STREAM_DIR / f"torch_smoke_{name}.evc", w, h,
                          device=dev.type, port_hook=hook)
        log(f"phase stage-diff: {name}"
            f"{' with a planted chroma ver fault' if hook else ''}:\n"
            + D.format_stages(d))
        got = {m for m, x in d.items() if x["equal"]}
        if got != agree:
            raise AssertionError(f"stage-diff on {name}: agree under "
                                 f"{sorted(got)}, expected {sorted(agree)}")
    log(f"phase stage-diff: {time.perf_counter() - t0:.1f} s")


def staging_phase(torch, dev):
    """The staging ring (ops/staging.py) on the config-3 cut and the 1080p
    IPPP cut, each decode equal to the numpy oracle: first with
    torch.cuda.set_sync_debug_mode("error") around every
    `TorchPixelBackend.decode_frame` (not around the reads), so any call
    in it that synchronises the host with the card raises; then at depth
    2 with a long torch.cuda._sleep on the stream before each frame's
    copies, so the pack two frames later finds its slot's copies still
    queued: the ring must have waited on a slot's event (`waits` > 0).
    Returns {stream: waits}."""
    from xevd_tpu_torch import TorchPixelBackend
    from xevd_tpu_torch.diff import port_decode

    class NoSyncBackend(TorchPixelBackend):
        """Raises on a synchronising call inside decode_frame."""

        def decode_frame(self, job, sps, refp):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return super().decode_frame(job, sps, refp)
            finally:
                torch.cuda.set_sync_debug_mode("default")

    def sleep_before_copies(stage):
        if stage == "pack":             # after the pack, before the copies
            torch.cuda._sleep(PRESSURE_SLEEP_CYCLES)

    log("phase staging: decode_frame under sync debug mode \"error\", then "
        "the ring at depth 2 under copies held back by sleeps")
    waits = {}
    for name in (MAIN_PATH, "1080p_p"):
        data = (STREAM_DIR / f"torch_smoke_{name}.evc").read_bytes()
        want = (WORK / f"{name}_np.yuv").read_bytes()
        for kind, backend in (
                ("sync debug", NoSyncBackend(dev)),
                ("pressure", TorchPixelBackend(
                    dev, on_stage=sleep_before_copies))):
            out = WORK / f"{name}_staging.yuv"
            t0 = time.perf_counter()
            n = port_decode(data, out, backend)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if out.read_bytes() != want:
                raise AssertionError(f"{name} {kind} decode differs from "
                                     "the numpy oracle")
            ring = backend.staging
            log(f"  {name} {kind}: {n} frames equal to the numpy oracle in "
                f"{wall:.3f} s; the ring ({len(ring.slots)} slots) waited "
                f"{ring.waits} times, {ring.wait_seconds * 1e3:.3f} ms")
            if kind == "pressure":
                if ring.waits == 0:
                    raise AssertionError(f"{name}: the ring never waited on "
                                         "a slot's event under pressure")
                waits[name] = ring.waits
    return waits


def device_ms(marks):
    """Device milliseconds between the stage marks of decodes (CUDA events;
    the pack and the upload's issue, host work, left out)."""
    return sum(marks[i - 1][1].elapsed_time(ev)
               for i, (stage, ev, _) in enumerate(marks)
               if stage not in ("start",) + HOST_STAGES)


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
    caps = [TG._capture_gop((WORK / "biggop" / f"{g}.evc").read_bytes(),
                            oracle=True)
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
    """The GOP batch with the Main MC taps: the main_gop_specs() GOPs,
    captured here, on one card: every batched kernel and the step on step
    1 against its batched plain version at G = 8 and G = 1 (the batched
    iqt/ATS ITDQ and Main-tap MC; MC in MC_LAUNCHES launches, timed);
    then the whole batch, every frame's MD5 equal to the oracle's.
    Returns its stats."""
    from tests.torch_helpers import gop_step_cases, mc_class_histogram
    from xevd_tpu_torch import bench as B
    from xevd_tpu_torch.ops import pack as PK
    from xevd_tpu_torch.parallel import gop as TG

    out, err = worker.communicate()
    if worker.returncode != 0:
        raise AssertionError(f"Main GOP stream worker failed (rc "
                             f"{worker.returncode}):\n{err[-4000:]}")
    t0 = time.perf_counter()
    caps = [TG._capture_gop((WORK / "maingop" / f"{g}.evc").read_bytes(),
                            oracle=True)
            for g in range(len(main_gop_specs()))]
    if not all(fr["pack"].main_taps and fr["pack"].iqt for c in caps
               for fr in c):
        raise AssertionError("Main GOP batch: a frame without the Main taps "
                             "or iqt")
    log(f"phase gop with the Main taps: {len(caps)} 176x144 Main IPPP GOPs "
        f"({', '.join(B.MAIN_GOP_TOOLS)}); streams "
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


def gop_launches(K, steps) -> dict:
    """The launches a batched run of `steps` (the PackedBatch of each step)
    must make, by counter: one a step for each kernel (a plane each for
    recon and the chroma passes), MC once a list with blocks, none of the
    others."""
    expect = dict.fromkeys(K.launch_counts, 0)
    for pb in steps:
        expect["gop_step"] += 1
        expect["itdq"] += int(pb.layout["tus"][1][0] > 0)
        expect["mc"] += sum(int(n > 0) for n in pb.mc_lists)
        expect["recon"] += 3
        expect["intra_scan"] += int(pb.layout["icu"][1][0] > 0)
        expect["pad"] += 1
        expect["deblock_luma"] += pb.deblock_on
        for kind in ("chroma_ver", "chroma_hor"):
            expect[f"deblock_{kind}"] += 2 * pb.deblock_on
    return expect


def gop_phase(torch, dev, K, results, workers):
    """K15: the 8 1080p GOPs as one batch per time step (parallel/gop.py),
    after each batched kernel and the batched step against its plain
    version on step 1 and on step 0 (the I pictures) at G = 8 and G = 1
    (the scan's and the step's on the CPU),
    and step 0's batched scan against each of its pictures scanned alone
    (at most 3x the slowest).  Returns (counts, frames/s per batched run,
    record)."""
    from tests.torch_helpers import gop_step_cases
    from xevd_tpu_torch import TorchPixelBackend
    from xevd_tpu_torch.diff import port_decode
    from xevd_tpu_torch.parallel import gop as TG

    from xevd_tpu_torch import bench as B
    log("phase gop: 8 1080p Baseline IPPP GOPs (K15); the committed streams "
        "captured (the numpy oracle's serial decodes) in worker processes")
    caps, committed, secs = gather_captures("gop", workers)
    for g, (c, sec) in enumerate(zip(caps, secs)):
        log(f"  GOP {g}: {len(c)} frames; capture (numpy oracle) {sec:.1f} s")

    # every worker has ended: the pad kernel again, on a quiet host
    from tests.torch_helpers import pad_picture_case
    log("phase pad again (no worker running)")
    results["pad"]["ms_after_workers"] = run_case(
        torch, pad_picture_case(dev, 8, 1080, 1920, seed=210), {}, 50, 50)

    from tests.torch_helpers import mc_class_histogram
    from tests.torch_mc_times import graph_ms
    from xevd_tpu_torch.ops import intra as TI
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
        "step 1, G = 8 and G = 1; the scan's and the step's plain versions "
        "on the CPU)")
    cpu = torch.device("cpu")
    for G in (len(caps), 1):
        for case in gop_step_cases(dev, caps[:G], plain_device=cpu):
            key = case.name if case.name == "gop_step" else f"gop_{case.name}"
            slow = case.name in ("intra_scan", "gop_step")
            ms = run_case(torch, case, results, 5 if slow else 20,
                          0 if slow else 3, main=G > 1, key=key)
            if G == 1:
                results[key]["ms_g1"] = ms

    # step 0, the 8 I pictures: the batched scan interleaves the frames'
    # CU rows (ops/pack.py icu_order), so it must cost about its slowest
    # frame's scan alone (the same kernel at G = 1), not their sum
    p0 = steps[0]
    icu0, off0 = PK._table(p0, "icu", 8), PK._table(p0, "icu_off", 0)
    tabs0 = [icu0[lo:hi] for lo, hi in zip(off0[:-1], off0[1:])]
    t = []
    for _ in range(3):
        t0 = time.perf_counter()
        PK.icu_order(tabs0, *p0.geom[2:])
        t.append(time.perf_counter() - t0)
    depth0 = TI.intra_dag_depth(icu0, *p0.geom[2:], icu_off=off0)
    log(f"phase gop step 0 (the {p0.G} I pictures, {len(icu0)} CUs, DAG "
        f"depth {depth0}; icu_order {min(t) * 1e3:.3f} ms of host time, "
        "best of 3: each batched kernel and the batched step at G = 8 and "
        "G = 1, then each picture's scan alone)")
    scan0, alone = None, []
    for G in (len(caps), 1):
        for case in gop_step_cases(dev, caps[:G], t=0, plain_device=cpu):
            key = case.name if case.name == "gop_step" else f"gop_{case.name}"
            slow = case.name in ("intra_scan", "gop_step")
            ms = run_case(torch, case, results, 5 if slow else 20,
                          0 if slow else 3, key=key)
            r = results[key]
            if G > 1:
                r["ms_step0"] = ms
                r["ms_device_step0"] = r["last_device_ms"]
            if case.name == "intra_scan":
                if G > 1:
                    scan0 = r["last_device_ms"]
                else:
                    alone.append(r["last_device_ms"])
    for c in caps[1:]:
        case, = (x for x in gop_step_cases(dev, [c], t=0)
                 if x.name == "intra_scan")
        alone.append(graph_ms(torch, case.kernel, 10))
    r = results["gop_intra_scan"]
    r.update(depth_step0=depth0, ms_device_step0_alone=alone,
             ms_device_step0_alone_max=max(alone))
    log(f"  step 0's batched scan {scan0:.4f} ms (device) at DAG depth "
        f"{depth0}; its pictures alone {[round(a, 4) for a in alone]} ms, "
        f"slowest {max(alone):.4f}: {scan0 / max(alone):.3f}x")
    if scan0 > 3 * max(alone):
        raise AssertionError(f"step 0's batched scan {scan0:.4f} ms > 3x its "
                             f"slowest picture alone ({max(alone):.4f} ms): "
                             "the frames' chains do not overlap")

    expect = gop_launches(K, steps)
    fps, counts, stats = [], None, None
    for rep in range(TIMED_RUNS_GOP):
        torch.cuda.synchronize()
        K.reset_counts()
        stats = {}
        dmd5, smd5 = TG.decode_gops_sharded(None, mesh=[dev], captures=caps,
                                            stats=stats)
        counts = dict(K.launch_counts)
        if dmd5 != smd5 or smd5 != committed:
            raise AssertionError("GOP batch: a frame's MD5 differs from the "
                                 "numpy oracle's (capture or committed)")
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
    marks = B.StageMarks(dev)
    split_stats = {}
    dmd5, _ = TG.decode_gops_sharded(None, mesh=[dev], captures=caps,
                                     stats=split_stats, on_stage=marks)
    if dmd5 != smd5:
        raise AssertionError("GOP batch (marked run): a frame's MD5 differs "
                             "from the numpy oracle's")
    log(f"  marked run in {split_stats['seconds'] * 1e3:.3f} ms; step split "
        "(ms; the copy into its pinned slot, issue of its copies, upload "
        "from the step's start until its kernels could be issued: host "
        "clock; the copies on the upload stream, the kernel stream's wait "
        "for them, run_frames_device, output: CUDA events):")
    for t, st in enumerate(B.gop_step_split(marks, split_stats["batches"][0])):
        log(f"    step {t}: {json.dumps(st)}")

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
    for g, evc in enumerate(B.gop_pair("gop")[0]):
        n += port_decode(evc.read_bytes(), WORK / f"gop{g}_t.yuv", backend)
        outs.append((WORK / f"gop{g}_t.yuv").read_bytes())
    w, h = B.GOP_SPECS[0][:2]
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


# config 5's one-card half (bench.GOP4K_SPECS): the phase's own limit, its
# worker captures not counted, and the kernels that must not launch on it
GOP4K_LIMIT_S = 330
GOP4K_BARRED = ("addb_frame", "alf_frame", "intra_scan_wave",
                "chroma_ver_ordered")
GOP4K_REPS = 5           # timed runs of each kernel in the 4K column


def gop4k_phase(torch, dev, K, results, workers):
    """Config 5's one-card half (BASELINE.json configs[4]): the 8 committed
    3840x2160 10-bit Main IPPP GOPs (bench.GOP4K_SPECS: iqt, ATS, ADMVP,
    cm_init; 2 or 3 frames, 20 pictures in 3 steps) decoded as one batch a
    step on the card.  The captures ran in workers (not counted in the
    phase's time).  A decode with the launch counters reset just before
    and read just after: each batched kernel once a step (MC on steps 1
    and 2; recon and the chroma passes once a plane), none of GOP4K_BARRED;
    every frame's MD5 equal to the capture's serial oracle and to the
    committed oracle MD5s (gop4k.json); the peak device memory and the
    pinned host buffers.  A second decode with the step split.  Step 0's
    batched scan (8 4K I pictures: its plain version would take minutes)
    is held to its own SCAN_LAUNCHES launches from the same inputs and,
    through the frames, to the MD5s; its device ms, DAG depth and
    `icu_order`'s host ms are printed.  The 4K column: every batched kernel
    and the batched step on step 1 at G = 8 held to its plain version
    (exact; the intra scan's and the step's plain versions on the CPU,
    copies of the same inputs), with device ms, a call's ms in 20-call
    graphs, the plain version's ms and the bound.  Fails past
    GOP4K_LIMIT_S.  Returns the phase's record."""
    from tests.torch_helpers import gop_step_cases, repeat_equal
    from tests.torch_mc_times import graph_ms
    from xevd_tpu_torch import bench as B
    from xevd_tpu_torch.ops import intra as TI
    from xevd_tpu_torch.ops import pack as PK
    from xevd_tpu_torch.parallel import gop as TG

    caps, md5s, secs = gather_captures("gop4k", workers)
    t0 = time.perf_counter()
    w, h = B.GOP4K_SPECS[0][:2]
    log(f"phase gop4k: {len(caps)} committed {w}x{h} 10-bit Main IPPP GOPs "
        f"({', '.join(B.MAIN_GOP_TOOLS)}), {sum(map(len, caps))} frames; "
        f"captures (numpy oracle, one worker a GOP) "
        f"{[round(x, 1) for x in secs]} s")
    if any(not (fr["pack"].main_taps and fr["pack"].iqt and fr["pack"].bd == 10)
           for c in caps for fr in c):
        raise AssertionError("gop4k: a frame without the Main taps, iqt or "
                             "10 bits")
    _, [(_, steps)] = TG._plan(caps, 1)
    p0 = steps[0]
    icu0, off0 = PK._table(p0, "icu", 8), PK._table(p0, "icu_off", 0)
    tabs0 = [icu0[lo:hi] for lo, hi in zip(off0[:-1], off0[1:])]
    t = []
    for _ in range(3):
        t1 = time.perf_counter()
        PK.icu_order(tabs0, *p0.geom[2:])
        t.append(time.perf_counter() - t1)
    order_ms = min(t) * 1e3
    depth0 = TI.intra_dag_depth(icu0, *p0.geom[2:], icu_off=off0)

    # the counted decode
    expect = gop_launches(K, steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    K.reset_counts()
    stats = {}
    dmd5, smd5 = TG.decode_gops_sharded(None, mesh=[dev], captures=caps,
                                        stats=stats)
    counts = dict(K.launch_counts)
    peak = torch.cuda.max_memory_allocated(dev)
    if dmd5 != smd5 or smd5 != md5s or \
            stats["checksum"] != stats["serial_checksum"]:
        raise AssertionError("gop4k batch: a frame's MD5 differs from the "
                             "numpy oracle's (capture or committed)")
    stray = [k for k in GOP4K_BARRED if counts[k]]
    missing = [k for k, n in expect.items() if n and not counts[k]]
    if counts != expect or stray or missing or \
            counts["intra_scan"] != stats["steps"]:
        raise AssertionError(f"gop4k launches {counts} != {expect} (never "
                             f"launched {missing}, barred {stray})")
    log(f"  counted decode: {stats['frames']} frames in {stats['steps']} "
        f"steps (batches {stats['batches'][0]}, DPB depth {stats['depth']}) "
        f"in {stats['seconds'] * 1e3:.3f} ms; every MD5 equal to the "
        f"capture's serial oracle and to the committed MD5s; launches "
        f"{counts}")
    log(f"  peak device memory {peak} B ({peak / 2 ** 30:.3f} GiB; {held} B "
        f"held before the decode); pinned host buffers (staging slots and "
        f"outputs) {stats['host_bytes']} B "
        f"({stats['host_bytes'] / 2 ** 30:.3f} GiB)")
    marks = B.StageMarks(dev)
    split = {}
    dmd5, _ = TG.decode_gops_sharded(None, mesh=[dev], captures=caps,
                                     stats=split, on_stage=marks)
    if dmd5 != md5s:
        raise AssertionError("gop4k batch (marked run): a frame's MD5 "
                             "differs from the committed oracle MD5s")
    fps = split["frames"] / split["seconds"]
    log(f"  marked run: {split['frames']} frames in "
        f"{split['seconds'] * 1e3:.3f} ms = {fps:.3f} frames/s; step split "
        "(as the gop phase's):")
    for st, x in enumerate(B.gop_step_split(marks, split["batches"][0])):
        log(f"    step {st}: {json.dumps(x)}")

    # step 0's batched scan: its launches held to each other
    case0, = (c for c in gop_step_cases(dev, caps, t=0)
              if c.name == "intra_scan")
    want = [None if x is None else x.clone() for x in case0.kernel()]
    err = repeat_equal(case0, want, SCAN_LAUNCHES - 1)
    if err:
        raise AssertionError(f"gop4k step 0: the batched scan's launches "
                             f"differ (max abs err {err} over "
                             f"{SCAN_LAUNCHES} launches)")
    scan0 = graph_ms(torch, case0.kernel, GOP4K_REPS)
    log(f"  step 0's batched scan ({p0.G} I pictures, {len(icu0)} CUs): "
        f"{SCAN_LAUNCHES} launches equal; {scan0:.4f} ms (device) at DAG "
        f"depth {depth0}; icu_order {order_ms:.3f} ms of host time (best "
        "of 3)")
    del case0, want

    # the 4K column: step 1 at G = 8
    log(f"phase gop4k kernels (each batched kernel and the batched step on "
        f"step 1, G = {steps[1].G}, {w}x{h} 10-bit)")
    cpu = torch.device("cpu")
    column = {}
    for case in gop_step_cases(dev, caps, t=1, plain_device=cpu):
        key = case.name if case.name == "gop_step" else f"gop_{case.name}"
        col = {}
        run_case(torch, case, col, GOP4K_REPS, 0, main=True, key=key,
                 launches=MC_LAUNCHES if case.name == "mc" else None)
        c = col[key]
        t_bytes = c["bytes"] / HBM_BYTES_PER_S
        t_ops = c["ops"] / SCALAR_OPS_PER_S
        column[key] = {
            "gop4k_launches": counts[case.name], "gop4k_ms": c["ms"],
            "gop4k_ms_device": c.get("ms_device"),
            "gop4k_ms_device_per_call": c.get("ms_device_per_call"),
            "gop4k_plain_ms": c["plain_ms"],
            "gop4k_plain_on": ("cpu" if case.name in ("intra_scan",
                                                      "gop_step")
                               else "cuda"),
            "gop4k_bound_ms": max(t_bytes, t_ops) * 1e3,
            "gop4k_bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "gop4k_shape": c["shape"]}
        r = results.setdefault(key, {"max_abs_err": 0})
        r["max_abs_err"] = max(r["max_abs_err"], c["max_abs_err"])
        r.update(column[key])
        log(f"  gop4k column {key:22s} device {c.get('ms_device', 0):.4f} ms"
            f" (graph), bound {column[key]['gop4k_bound_ms']:.4f} ms "
            f"({column[key]['gop4k_bound_by']}), plain {c['plain_ms']:.1f} "
            f"ms ({column[key]['gop4k_plain_on']})")
    results["gop_intra_scan"].update(gop4k_ms_device_step0=scan0,
                                     gop4k_depth_step0=depth0,
                                     gop4k_icu_order_ms=order_ms)
    results["gop_step"].update(gop4k_fps=fps, gop4k_peak_bytes=peak,
                               gop4k_pinned_bytes=stats["host_bytes"])
    del caps
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log(f"  gop4k on {gpu_line()}: phase {seconds:.1f} s (captures in "
        f"workers not counted)")
    if seconds > GOP4K_LIMIT_S:
        raise AssertionError(f"gop4k phase took {seconds:.1f} s, over "
                             f"{GOP4K_LIMIT_S} s")
    return {"gops": len(md5s), "frames": stats["frames"],
            "steps": stats["steps"], "batches": stats["batches"],
            "fps": fps, "ms": split["seconds"] * 1e3, "peak_bytes": peak,
            "held_bytes": held, "pinned_bytes": stats["host_bytes"],
            "scan0_ms_device": scan0, "depth_step0": depth0,
            "icu_order_ms": order_ms, "capture_s": secs,
            "seconds": seconds}


def entry_phase(torch, K):
    """The graft entry (xevd_tpu_torch/entry.py): its step on the card --
    ITDQ, recon and K8, one launch each -- equal to its plain versions' on
    the CPU."""
    from xevd_tpu_torch.entry import entry
    fn, args = entry("cuda")
    names = ("itdq", "recon", "deblock_luma")
    before = {k: K.launch_counts[k] for k in names}
    got = fn(*args).cpu()
    launches = {k: K.launch_counts[k] - before[k] for k in names}
    fn_c, args_c = entry("cpu")
    if launches != dict.fromkeys(names, 1) or not torch.equal(
            got, fn_c(*args_c)):
        raise AssertionError(f"entry('cuda') != entry('cpu') or launches "
                             f"{launches}")
    log(f"phase entry: entry('cuda') step equal to entry('cpu'), "
        f"{tuple(got.shape)}; launches {launches}")


def bench_phase(torch, dev):
    """The port's benchmark functions (xevd_tpu_torch/bench.py), two timed
    runs each, once every worker has ended: the 1080p IPPP and config-3
    streams (as its configs 2 and 3) against their oracle MD5s, and the 8
    1080p GOPs; every decode equal to the oracle (the functions raise
    otherwise), and bench.py's keys in the report, which is logged.
    Returns the phase's seconds."""
    from xevd_tpu_torch import bench as B
    t0 = time.perf_counter()
    configs = {}
    for key, name in (("c2", "1080p_p"), ("c3", MAIN_PATH)):
        w, h = STREAMS[name][:2]
        md5s = B.yuv_md5s((WORK / f"{name}_np.yuv").read_bytes(), w, h)
        configs[key] = B.run_config(
            (STREAM_DIR / f"torch_smoke_{name}.evc").read_bytes(), md5s, dev,
            runs=2)
    caps = [pickle.loads((WORK / f"gop{g}.pkl").read_bytes())
            for g in range(len(B.GOP_SPECS))]
    gop = B.run_gop(caps, [dev], runs=2)
    out = B.report(configs, gop, card=gpu_line())
    missing = [k for k in B.KEYS if k not in out]
    empty = [k for k in B.KEYS if out[k] is None
             and not k.startswith(("vs_", "ref_"))]
    if missing or empty or out["device"] != "cuda" or \
            len(out["value_runs"]) != 2 or len(gop["fps_runs"]) != 2:
        raise AssertionError(f"bench report: keys missing {missing}, empty "
                             f"{empty}")
    seconds = time.perf_counter() - t0
    log(json.dumps(out))
    log(f"phase bench: configs 2 and 3 (the smoke's streams) and the GOP "
        f"batch, 2 timed runs each, every frame equal to the oracle; "
        f"frames/s c2 {out['value_runs']}, c3 {out['fps_main_runs']}, GOP "
        f"{gop['fps_runs']}; busy share c3 "
        f"{configs['c3']['traced']['busy_share']}; {seconds:.1f} s")
    return seconds


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
    # the 4K GOP captures first: theirs is the longest host work
    gop4k_workers = start_captures("gop4k")
    gop_workers = start_captures("gop")
    big_gop_worker = start_streams_worker(BIG_GOP_SPECS, "biggop")
    main_gop_worker = start_streams_worker(main_gop_specs(), "maingop")
    prepared = {name: start_reference(name) for name in STREAMS}
    try:
        K.build(verbose=True)      # always from this checkout's sources
        K.lib()
        log(f"build: nvcc {K.build_seconds:.1f} s, one process a source "
            f"({', '.join(K.SOURCES)} -> {K.BUILD_DIR.relative_to(REPO)})")

        results = {}
        kernel_phases(torch, dev, results)
        entry_phase(torch, K)
        runs = slice_phase(torch, dev, K, results, prepared)
        c4 = c4_phase(torch, dev, K, results)
        stage_diff_phase(dev)
        ring_waits = staging_phase(torch, dev)
        runs["gop"] = gop_phase(torch, dev, K, results, gop_workers)
        gop4k = gop4k_phase(torch, dev, K, results, gop4k_workers)
        big_gop = big_gop_phase(torch, dev, K, results, big_gop_worker)
        main_gop = main_gop_phase(torch, dev, K, results, main_gop_worker)
        bench_s = bench_phase(torch, dev)
    finally:
        for p in (list(prepared.values()) + gop4k_workers + gop_workers
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
        extra = {k: r[k] for k in r
                 if k.startswith(("ms_", "library_", "depth_", "c4_",
                                   "gop4k_"))
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
    log(f"staging ring waits under pressure: {json.dumps(ring_waits)}")
    log(f"config 4 (3840x2160 10-bit Main RA): {json.dumps(c4)}")
    log(f"config 5's one-card half (8 3840x2160 10-bit Main IPPP GOPs): "
        f"{json.dumps(gop4k)}")
    log(f"bench phase {bench_s:.1f} s")
    log(f"total smoke time {time.perf_counter() - t_start:.1f} s")
    log(gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
