"""The GOP batch's Baseline intra scan (K5's batched launch, csrc/intra.cu)
traced on the card: where its tickets stand over time on step 0 of the
bench's 8 1080p GOPs (their I pictures), with the rows handed out in
table order (frame after frame: the scan's order before the batch had a
ticket order), round-robin over the frames by row index ("rr": each
frame's rows in table order), in the pack's ticket order (ops/pack.py
`icu_order`: by depth in each frame's DAG, "level"), and each frame
scanned alone.

    python tests/torch_scan_trace.py

Builds csrc/intra.cu with -DXEVD_INTRA_TRACE into a library of its own
under build/xevd_tpu_torch/trace/ (the port's library never holds the
trace): thread 0 of the CTA that scans row n writes the %globaltimer
(ns) when it took the row's ticket and when it published the row's done
flag.  The traced library is swapped in for one scan at a time through
the port's own wrapper (`ops/intra.py` `intra_scan`), on the planes the
path gives the scan: `xevd_tpu_torch.bench.prepare(["gop"])` makes or
finds the streams and captures them in workers, `parallel/gop.py` `_plan`
stacks step 0, and the port's ITDQ and recon kernels produce the
residuals and planes.  Every traced scan's planes are held to the port's
untraced batched scan, frame by frame.

Also times, by CUDA events, each variant's untraced scan (the mean of 5
launches) and `run_frames_device` on step 0 stage by stage (its marks;
the median of 3 runs) in each batched order, and, by the host clock,
`icu_order` on step 0's tables (the best of 3).

Prints the card (nvidia-smi name and power limit) first and last, a line
a variant (the scan's ms; the traced span; each frame's first ticket and
last done flag, us from the launch's first ticket; the overlap, the sum
of the frames' spans over the launch's span: 1 when the frames run one
after another, G when side by side) and, as the last line, one JSON
object with all of it and the rows each frame finished in each of 20
equal slices of the span, also written to chiprun_out/scan_trace.json.
Needs a CUDA device; imports no JAX."""
import ctypes
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "chiprun_out"
SLICES = 20
LAUNCHES = 5


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def trace_lib(K):
    """csrc/intra.cu built with the trace, its entry points bound as the
    port binds its own."""
    out = K.BUILD_DIR / "trace" / "libxevd_intra_trace.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    K._run([[K._nvcc(), *K.NVCC_FLAGS, "-DXEVD_INTRA_TRACE", "-shared",
             "-o", str(out), str(K.CSRC / "intra.cu")]])
    lib = ctypes.CDLL(str(out))
    for name in ("xevd_intra_scan", "xevd_intra_scan_grid"):
        fn = getattr(lib, name)
        fn.argtypes = K.SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.xevd_intra_trace_set.argtypes = (ctypes.c_void_p,)
    lib.xevd_intra_trace_set.restype = ctypes.c_int
    return lib


def traced_scan(torch, K, TI, lib, recs, resids, icu, off, order, bd):
    """One scan by the traced library on copies of `recs`: (planes, int64
    [n, 2] ns, a row's ticket taken and its done flag published)."""
    buf = torch.zeros(icu.shape[0], 2, dtype=torch.int64, device=icu.device)
    planes = [r.clone() for r in recs]
    K.check(lib.xevd_intra_trace_set(buf.data_ptr()), "xevd_intra_trace_set")
    prev, K._LIB = K._LIB, lib
    try:
        TI.intra_scan(planes, resids, icu, bd, True, icu_off=off, order=order)
        torch.cuda.synchronize()
    finally:
        K._LIB = prev
        K.check(lib.xevd_intra_trace_set(None), "xevd_intra_trace_set")
    return planes, buf.cpu().numpy()


def scan_ms(torch, TI, recs, resids, icu, off, order, bd):
    """Mean ms (CUDA events) of LAUNCHES untraced scans, in place on copies
    (a scan of planes it already reconstructed writes the same samples)."""
    planes = [r.clone() for r in recs]
    TI.intra_scan(planes, resids, icu, bd, True, icu_off=off, order=order)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(LAUNCHES):
        TI.intra_scan(planes, resids, icu, bd, True, icu_off=off,
                      order=order)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / LAUNCHES


def summary(tr, off) -> dict:
    """Each frame's first ticket and last done flag (us from the launch's
    first ticket), the span, the overlap and the rows finished a slice."""
    t0 = tr[:, 0].min()
    span = (tr[:, 1].max() - t0) / 1e3
    edges = np.linspace(0, span, SLICES + 1)
    frames = []
    for lo, hi in zip(off[:-1], off[1:]):
        if hi == lo:
            frames.append(None)
            continue
        frames.append({
            "first_ticket_us": (tr[lo:hi, 0].min() - t0) / 1e3,
            "last_done_us": (tr[lo:hi, 1].max() - t0) / 1e3,
            "done_a_slice": np.histogram((tr[lo:hi, 1] - t0) / 1e3,
                                         edges)[0].tolist()})
    busy = sum(f["last_done_us"] - f["first_ticket_us"] for f in frames if f)
    return {"span_us": span, "overlap": busy / span if span else None,
            "frames": frames}


def stage_ms(torch, B, run_frames_device, batch, tables, dpb, runs=3):
    """Median device ms of each stage of `run_frames_device` on `batch`."""
    per = {}
    for _ in range(runs):
        marks = B.StageMarks(batch.tus.device)
        marks("start")
        run_frames_device(batch, tables, dpb, marks)
        torch.cuda.synchronize()
        for name, _, dms in marks.intervals():
            per.setdefault(name, []).append(dms)
    out = {k: statistics.median(v) for k, v in per.items()}
    out["step"] = sum(out.values())
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_scan_trace: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from xevd_tpu_torch import bench as B
    from xevd_tpu_torch.kernels import build as K
    from xevd_tpu_torch.ops import intra as TI
    from xevd_tpu_torch.ops import itdq as TQ
    from xevd_tpu_torch.ops import pack as PK
    from xevd_tpu_torch.ops import recon as TR
    from xevd_tpu_torch.ops.pipeline import run_frames_device
    from xevd_tpu_torch.ops.tables import device_tables
    from xevd_tpu_torch.parallel import gop as TG

    card = smi()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    _, gops, info = B.prepare(["gop"])
    caps = gops["gop"][0]
    print(f"captures: {json.dumps(info)}", flush=True)
    K.lib()
    lib = trace_lib(K)
    D, [(gops, steps)] = TG._plan(caps, 1)
    pb = steps[0]
    h, w, h_scu, w_scu = pb.geom
    bd = pb.bd
    tables = device_tables(dev)
    b = PK.upload_batch(pb, dev)
    resids = TQ.itdq((b.coef_y, b.coef_u, b.coef_v), b.tus, pb.shp_y,
                     pb.shp_c, bd, tables, pb.iqt, tu_off=b.tu_off,
                     order=b.tu_order)
    recs = [TR.recon(r, bd) for r in resids]
    off = b.icu_off.cpu().numpy()
    icu_host = b.icu.cpu()
    depths = [TI.intra_dag_depth(icu_host[lo:hi], h_scu, w_scu)
              for lo, hi in zip(off[:-1], off[1:])]
    ident = torch.arange(b.icu.shape[0], dtype=torch.int32, device=dev)
    want = [r.clone() for r in recs]
    TI.intra_scan(want, resids, b.icu, bd, True, icu_off=b.icu_off,
                  order=b.icu_order)
    torch.cuda.synchronize()
    result = {"card": card, "G": pb.G, "cus": np.diff(off).tolist(),
              "depths": depths, "grid": K.persistent_grid("xevd_intra_scan"),
              "variants": {}}
    print(f"step 0: G {pb.G}, CUs a frame {result['cus']}, depths {depths}, "
          f"persistent grid {result['grid']} CTAs", flush=True)

    def run(key, rcs, res, icu, o, order):
        planes, tr = traced_scan(torch, K, TI, lib, rcs, res, icu, o, order,
                                 bd)
        ms = scan_ms(torch, TI, rcs, res, icu, o, order, bd)
        s = dict(summary(tr, o.cpu().numpy()), ms=ms)
        result["variants"][key] = s
        firsts = [None if f is None else round(f["first_ticket_us"], 1)
                  for f in s["frames"]]
        lasts = [None if f is None else round(f["last_done_us"], 1)
                 for f in s["frames"]]
        print(f"{key}: scan {ms:.4f} ms; traced span {s['span_us']:.1f} us, "
              f"overlap {s['overlap']:.3f}; first tickets {firsts}; last "
              f"done {lasts}", flush=True)
        return planes

    counts = np.diff(off)
    k = np.arange(len(icu_host)) - np.repeat(off[:-1], counts)
    rr = torch.from_numpy(np.argsort(k, kind="stable").astype(np.int32))
    orders = {"table": ident, "rr": rr.to(dev), "level": b.icu_order}
    for key, order in orders.items():
        got = run(key, recs, resids, b.icu, b.icu_off, order)
        if any(not torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"traced scan in {key} order != the port's")
    for g, (lo, hi) in enumerate(zip(off[:-1], off[1:])):
        got = run(f"alone{g}", [r[g:g + 1] for r in recs],
                  [r[g:g + 1] for r in resids], b.icu[lo:hi],
                  torch.tensor([0, hi - lo], dtype=torch.int32, device=dev),
                  ident[:hi - lo])
        if any(not torch.equal(x[0], y[g]) for x, y in zip(got, want)):
            raise AssertionError(f"frame {g} scanned alone != in the batch")
    alone = [result["variants"][f"alone{g}"] for g in range(pb.G)]
    result["alone_max_ms"] = max(a["ms"] for a in alone)
    result["us_a_step_alone"] = [a["span_us"] / d
                                 for a, d in zip(alone, depths)]

    run_ = TG._DeviceRun(dev, gops, steps, D, h, w)
    dpb = run_.dpb(0, pb.G)
    result["stages_ms"] = {
        key: stage_ms(torch, B, run_frames_device,
                      dataclasses.replace(b, icu_order=order), tables, dpb)
        for key, order in orders.items()}
    tabs = [icu_host[lo:hi].numpy() for lo, hi in zip(off[:-1], off[1:])]
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        PK.icu_order(tabs, h_scu, w_scu)
        host.append((time.perf_counter() - t0) * 1e3)
    result["icu_order_host_ms"] = min(host)
    print(f"icu_order on step 0's {len(icu_host)} rows: {min(host):.1f} ms "
          "(host clock, best of 3)", flush=True)
    for key, st in result["stages_ms"].items():
        print(f"run_frames_device step 0, {key} order: "
              f"{json.dumps({k: round(v, 4) for k, v in st.items()})}",
              flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "scan_trace.json").write_text(json.dumps(result))
    print(smi())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
