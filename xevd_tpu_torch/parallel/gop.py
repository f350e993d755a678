"""GOP-batched decode of independent IDR-led GOPs on the card: the port of
K15, `decode_gops_sharded` (xevd_tpu/parallel/gop.py:89-253).

Random access starts at IDR pictures, so the GOPs of a stream decode
independently.  The JAX package decodes a batch of GOPs in one jitted SPMD
step: the per-frame pixel pipeline `jax.vmap`'d over the GOP axis, that
axis sharded over a mesh, the DPB carried on the device and a psum'd
checksum.  Here:

  host    each GOP is entropy-decoded and derived serially by the port's
          host `Decoder` over the numpy oracle backend (`_capture_gop`),
          which keeps each frame's pack (ops/pack.py; its reference planes
          dropped -- the device DPB supplies them), the oracle's planes and
          the POC;
  device  the GOPs are split over the mesh's devices in equal blocks, as
          JAX shards them; each device works on a CUDA stream of its own,
          and uploads on a second one.  Every step is stacked first
          (ops/pack.py `stack_frames`), as JAX stacks every step before its
          one transfer (xevd_tpu/parallel/gop.py:192-199, 221).  Time step
          t of a device then copies its stacked arrays into a pinned
          staging slot of its own (ops/staging.py) and issues their two
          copies on the upload stream; the kernel stream waits for them
          (an event, not the host) and runs the t-th frames of the
          device's GOPs as ONE batch through `ops/pipeline.
          run_frames_device`: one launch per kernel per step, whatever the
          batch -- the GOP axis is a batch axis of the kernels
          (csrc/batch.cuh), and the intra scan interleaves the frames'
          CU rows (ops/pack.py `icu_order`), so a step's scan costs about
          its longest frame's chain, as JAX's vmapped scan does.  No upload waits for a kernel: step t + 1 is
          staged and copied while step t's kernels run.  The DPB is a
          carry on the device, int16 [D, G_dev, h + 2 PAD, w + 2 PAD] a
          plane, written as a ring (step t into slot t % D; no picture is
          copied), and MC addresses a step's references, picture (d, g)
          with d the steps back from the reference's POC, by the ring's
          strides (ops/mc.py `DpbRing`), so a device takes any D x G_dev,
          as JAX's step does.

A GOP that has ended leaves the batch of the later steps (JAX pads it with
inert copies of its last frame, gop.py:113-124): a device's GOPs are
ordered by length, so the GOPs of step t are a prefix of its batch.  The
outputs of real frames are the same, and no work goes to pad frames.

The checksum is a device-side int64 sum of the cropped luma of every real
frame, brought to the first device: it equals the same sum over the serial
oracle's planes.  (JAX's, gop.py:224, sums every step's whole padded
output, the garbage of pad frames included.)

Refused with UnsupportedStream before any device work, as the JAX step
refuses them or cannot decode them exactly: GOPs whose pictures differ in
size, bit depth or chroma format, and chroma formats other than 4:2:0
(gop.py:138-141, 202-204); references that are not earlier pictures of
their GOP, in decode and in output order, so RA GOPs (:150); SUCO (:180);
ALF (the step passes alf=None, xevd_tpu/ops/pipeline.py:382-384); EIPD
(per-GOP level schedules break the shared statics); and ADDB, which has
no batched kernel.  Baseline IPPP GOPs are the path.

    python -m xevd_tpu_torch.parallel.gop [--device cuda|cpu] [--devices N]
        GOP.evc ...         decode the GOPs as one batch; every frame's MD5
                            must equal the serial oracle's
    python -m xevd_tpu_torch.parallel.gop --capture GOP.evc OUT.pkl
                            capture one GOP into a file (a worker process)
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import pickle
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import spans as SP
from ..device import resolve_device
from ..host import NAL_UNIT_LENGTH_BYTE, Decoder, info
from ..host import tables as T
from ..host.decoder import NumpyPixelBackend
from ..host.syntax import UnsupportedStream
from ..ops import pack as PK
from ..ops.mc import DpbRing
from ..ops.pipeline import DpbStep, TorchPixelBackend, run_frames_device
from ..ops.staging import HostStaging
from ..ops.tables import device_tables

PAD_L, PAD_C = T.PIC_PAD_SIZE_L, T.PIC_PAD_SIZE_C


def make_mesh(n_devices=None) -> list:
    """The devices the GOPs are split over: cuda:0 .. n - 1 (every visible
    card by default), or the devices named in a list (["cpu"] * n runs the
    plain versions, as the tests do)."""
    if isinstance(n_devices, (list, tuple)):
        return [resolve_device(d) for d in n_devices]
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: torch.cuda.is_available() is False; "
                           "name the devices, e.g. ['cpu'] * n")
    n = torch.cuda.device_count() if n_devices is None else n_devices
    if not 0 < n <= torch.cuda.device_count():
        raise ValueError(f"make_mesh: {n} of {torch.cuda.device_count()} "
                         "CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


def _nalu_walk(data: bytes):
    pos = 0
    while pos + NAL_UNIT_LENGTH_BYTE <= len(data):
        ln, _, _ = info(data[pos:pos + 6])
        pos += NAL_UNIT_LENGTH_BYTE
        yield data[pos:pos + ln]
        pos += ln


class _Capture(NumpyPixelBackend):
    """The numpy oracle backend, keeping each frame's pack, planes and POC;
    refuses at the SPS what the GOP batch cannot decode."""

    def __init__(self):
        self.frames = []
        self.dec = None

    def check_caps(self, sps):
        TorchPixelBackend.check_caps(self, sps)
        tools = [what for flag, what in (
            ("sps_suco_flag", "SUCO"), ("tool_eipd", "EIPD"),
            ("tool_addb", "ADDB"), ("tool_alf", "ALF"))
            if getattr(sps, flag, 0)]
        if tools:
            raise UnsupportedStream(f"torch GOP batch: streams with "
                                    f"{', '.join(tools)} are not batched "
                                    "(see parallel/gop.py)")
        if sps.chroma_format_idc != 1:
            raise UnsupportedStream("torch GOP batch: 4:2:0 only")

    def decode_frame(self, job, sps, refp):
        with SP.span("capture.pack"):
            pf = PK.pack_frame(job, sps, refp, plane=np.asarray)
        with SP.span("capture.numpy"):
            rec = NumpyPixelBackend.decode_frame(self, job, sps, refp)
        self.frames.append({"pack": dataclasses.replace(pf, refs=()),
                            "rec": rec, "poc": self.dec.poc.poc_val})
        return rec


def _capture_gop(data: bytes) -> list:
    """Serially decode one GOP with the numpy oracle; per frame a dict of
    its pack (`PackedFrame`, refs dropped), the oracle's planes `rec`
    (y, u, v; CTU-padded, unbordered) and its `poc`.  The first frame's
    dict also holds `spans`, the `spans.Record` of the capture: the span
    `capture.gop` (all of it), the decoder's `host.*` spans and per picture
    `capture.pack` and `capture.numpy`."""
    cap = _Capture()
    with SP.record() as rec, SP.span("capture.gop"):
        dec = Decoder(backend=cap)
        cap.dec = dec
        for nalu in _nalu_walk(data):
            dec.decode(nalu)
    if cap.frames:
        cap.frames[0]["spans"] = rec
    return cap.frames


def _crop_md5(y, u, v, h, w):
    """MD5 over the cropped 4:2:0 planes (uint16 LE, like the picture
    signature in src_base/xevd_util.c:985-1002)."""
    m = hashlib.md5()
    for p, ph, pw in ((y, h, w), (u, h >> 1, w >> 1), (v, h >> 1, w >> 1)):
        m.update(np.ascontiguousarray(
            np.asarray(p[:ph, :pw]).astype("<u2")).tobytes())
    return m.hexdigest()


def _plan(caps, n_dev):
    """(D, [(gops, batches)] per device): the DPB depth, and per device its
    GOPs (longest first) and the PackedBatch of each of its steps.  Raises
    UnsupportedStream for what the batch cannot decode."""
    if any(not c for c in caps):
        raise ValueError("a GOP without frames")
    f0 = caps[0][0]["pack"]
    for c in caps:
        for fr in c:
            p = fr["pack"]
            if (p.geom[:2], p.bd, p.chroma) != (f0.geom[:2], f0.bd,
                                                f0.chroma):
                raise UnsupportedStream("torch GOP batch: GOPs whose pictures "
                                        "differ in size, bit depth or chroma "
                                        "format")
    if not f0.chroma:
        raise UnsupportedStream("torch GOP batch: 4:2:0 only")
    # each reference slot as the steps back to the GOP's picture of its POC
    deltas, D = [], 1
    for c in caps:
        step_of, dg = {}, []
        for t, fr in enumerate(c):
            ds = []
            for poc in fr["pack"].ref_pocs:
                if poc not in step_of or poc >= fr["poc"]:
                    raise UnsupportedStream(
                        "torch GOP batch: a reference that is not an earlier "
                        "picture of its GOP, in decode and output order (RA "
                        "GOPs are refused, as at xevd_tpu/parallel/gop.py:"
                        "150)")
                ds.append(t - step_of[poc])
            step_of[fr["poc"]] = t
            dg.append(ds)
            D = max([D] + ds)
        deltas.append(dg)
    Gd = len(caps) // n_dev
    plan = []
    for k in range(n_dev):
        gops = sorted(range(k * Gd, (k + 1) * Gd), key=lambda g: -len(caps[g]))
        steps = []
        for t in range(len(caps[gops[0]])):
            act = [g for g in gops if len(caps[g]) > t]
            steps.append(PK.stack_frames(
                [caps[g][t]["pack"] for g in act],
                [[(d - 1) * Gd + b for d in deltas[g][t]]
                 for b, g in enumerate(act)]))
        plan.append((gops, steps))
    return D, plan


_STREAMS = {}


def _streams(dev) -> tuple:
    """(kernel stream, upload stream) of CUDA device `dev`, the same for
    every batch: the caching allocator keeps a freed block for the stream
    that allocated it, so a batch on new streams would allocate every
    device buffer anew (cudaMalloc) inside its clock."""
    if dev not in _STREAMS:
        _STREAMS[dev] = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    return _STREAMS[dev]


class _DeviceRun:
    """One device's part: its GOPs, their steps, the DPB ring, the
    checksum, a staging slot a step (pinned on a card, sized here: no step
    waits for a slot, and no pinned buffer is allocated while the batch's
    clock runs) and the host buffers of the outputs."""

    def __init__(self, dev, gops, steps, D, h, w):
        self.dev, self.gops, self.steps, self.D = dev, gops, steps, D
        self.h, self.w = h, w
        self.cuda = dev.type == "cuda"
        self.stream, self.copy_stream = (_streams(dev) if self.cuda
                                         else (None, None))
        with self._on():
            self.staging = HostStaging(dev, len(steps))
            for slot, pb in zip(self.staging.slots, steps):
                slot.reserve(pb.payload.size, pb.coefs.size)
            self.tables = device_tables(dev)
            shapes = ((h + 2 * PAD_L, w + 2 * PAD_L),
                      ((h >> 1) + 2 * PAD_C, (w >> 1) + 2 * PAD_C),
                      ((h >> 1) + 2 * PAD_C, (w >> 1) + 2 * PAD_C))
            self.ring = tuple(torch.zeros((D, len(gops)) + s,
                                          dtype=torch.int16, device=dev)
                              for s in shapes)
            self.checksum = torch.zeros((), dtype=torch.int64, device=dev)
        # the outputs of each step, cropped, on the host (pinned: the
        # copies overlap the next steps)
        self.host = [tuple(torch.empty((pb.G, h >> s, w >> s),
                                       dtype=torch.int16,
                                       pin_memory=self.cuda)
                           for s in (0, 1, 1)) for pb in steps]

    def host_bytes(self) -> int:
        """The bytes of its host buffers (pinned on a card): the staging
        slots and the outputs."""
        return (sum(s.payload.nbytes + s.coefs.nbytes
                    for s in self.staging.slots)
                + sum(p.nbytes for planes in self.host for p in planes))

    def _on(self):
        """This device and its stream as the current ones."""
        if not self.cuda:
            return contextlib.nullcontext()
        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.cuda.device(self.dev))
        ctx.enter_context(torch.cuda.stream(self.stream))
        return ctx

    def dpb(self, t, G):
        """The DPB as step t sees it: reference slot (d - 1) * G_dev + g is
        GOP g's picture d steps back (`DpbRing`); the step writes ring
        slot t % D."""
        return DpbStep(refs=DpbRing(self.ring, t),
                       out=tuple(p[t % self.D][:G] for p in self.ring))

    def _copying(self):
        """The upload stream as the current one."""
        return (torch.cuda.stream(self.copy_stream) if self.cuda
                else contextlib.nullcontext())

    def step(self, t, mark=None):
        """Issue step t: copy its stacked arrays into its staging slot and
        issue their copies on the upload stream, then its kernels on this
        device's stream, which waits for the copies by an event (the host
        does not).  `mark(name)` is called with this device current: at
        "start" (its stream current), after the copy into the slot
        ("stage") and after the copies to the card were issued ("copy"),
        both with the upload stream current, after the kernel stream's
        wait was issued ("wait"), after each stage of `run_frames_device`
        ("itdq", "mc", "recon", "intra", "deblock", "pad"), after it
        returned ("step") and after the checksum and the output copies
        ("output")."""
        mark = mark or (lambda name: None)
        with self._on():
            mark("start")
            slot = self.staging.acquire()
            with self._copying():
                pb = PK.stage_batch(self.steps[t], slot)
                mark("stage")
                batch = PK.upload_batch(pb, self.dev, reader=self.stream)
                mark("copy")
            mark("wait")
            out = run_frames_device(batch, self.tables, self.dpb(t, pb.G),
                                    mark)
            mark("step")
            crops = [o[:, P:P + (self.h >> s), P:P + (self.w >> s)]
                     for o, P, s in zip(out, (PAD_L, PAD_C, PAD_C),
                                        (0, 1, 1))]
            self.checksum += crops[0].sum(dtype=torch.int64)
            for host, c in zip(self.host[t], crops):
                host.copy_(c, non_blocking=self.cuda)
            mark("output")

    def finish(self):
        if self.cuda:
            self.copy_stream.synchronize()
            self.stream.synchronize()

    def outputs(self):
        """{gop: [(y, u, v) cropped numpy planes per frame]}."""
        out = {g: [] for g in self.gops}
        for t, planes in enumerate(self.host):
            for b in range(planes[0].shape[0]):
                out[self.gops[b]].append(tuple(p[b].numpy() for p in planes))
        return out


@SP.entry()
def decode_gops_sharded(streams: list[bytes], mesh=None,
                        n_devices: int | None = None, verbose=False,
                        captures=None, stats: dict | None = None,
                        on_stage=None):
    """Decode `streams` (one independent IDR-led GOP each), or `captures`
    made elsewhere by `_capture_gop`, as one batch per time step on each
    device of `mesh` (`make_mesh(n_devices)` by default).  Returns
    (device_md5s, serial_md5s): per GOP, per frame plane digests, equal
    iff the batched decode is bit-exact against the serial oracle.
    `stats`, if given, receives the checksum (device), the serial one,
    the step count, the DPB depth, the batch size of each step, the
    frames, `seconds`, the host clock from the first upload to the last
    output on the host, and `host_bytes`, the staging slots and output
    buffers the devices' runs hold on the host (pinned on a card).
    `on_stage(name)`, if given, marks each step of each device
    (`_DeviceRun.step`).

    Each call is an entry call of `spans` (numbered; the last KEEP kept):
    the spans `entry.plan` (`_plan`), `entry.alloc` (the `_DeviceRun`s),
    `entry.steps` (the steps to `finish`: `seconds`), `entry.outputs` (the
    outputs and their MD5s) and `entry.serial` (the captured planes' MD5s,
    and their luma sum where `stats` is given), the counter `stage.bytes`,
    and the spans of each capture, taken in from its first frame's
    `spans`."""
    if mesh is None:
        mesh = make_mesh(n_devices)
    caps = (list(captures) if captures is not None
            else [_capture_gop(s) for s in streams])
    for c in caps:
        if c and "spans" in c[0]:
            SP.take(c[0]["spans"])
    G = len(caps)
    if G == 0 or G % len(mesh):
        raise ValueError(f"{G} GOPs do not tile a mesh of {len(mesh)}")
    with SP.span("entry.plan"):
        D, plan = _plan(caps, len(mesh))
    h, w = caps[0][0]["pack"].geom[:2]
    with SP.span("entry.alloc"):
        runs = [_DeviceRun(dev, gops, steps, D, h, w)
                for dev, (gops, steps) in zip(mesh, plan)]
    with SP.span("entry.steps"):
        t0 = time.perf_counter()
        for t in range(max(len(r.steps) for r in runs)):
            for r in runs:  # the devices' streams run side by side
                if t < len(r.steps):
                    r.step(t, on_stage)
        for r in runs:
            r.finish()
        seconds = time.perf_counter() - t0
    with SP.span("entry.outputs"):
        checksum = int(sum(r.checksum.to(mesh[0]) for r in runs))
        device_md5s = [None] * G
        for r in runs:
            for g, frames in r.outputs().items():
                device_md5s[g] = [_crop_md5(*p, h, w) for p in frames]
    with SP.span("entry.serial"):
        serial_md5s = [[_crop_md5(*fr["rec"], h, w) for fr in c]
                       for c in caps]
        if stats is not None:
            stats["serial_checksum"] = sum(
                int(fr["rec"][0][:h, :w].astype(np.int64).sum())
                for c in caps for fr in c)
    if stats is not None:
        stats.update(
            checksum=checksum,
            steps=max(len(r.steps) for r in runs), depth=D,
            batches=[[pb.G for pb in r.steps] for r in runs],
            frames=sum(len(c) for c in caps), seconds=seconds,
            host_bytes=sum(r.host_bytes() for r in runs))
    if verbose:
        for g in range(G):
            for t in range(len(device_md5s[g])):
                ok = device_md5s[g][t] == serial_md5s[g][t]
                print(f"gop {g} frame {t}: device {device_md5s[g][t][:12]} "
                      f"serial {serial_md5s[g][t][:12]} "
                      f"{'OK' if ok else 'MISMATCH'}")
        print(f"checksum: {checksum}")
    return device_md5s, serial_md5s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m xevd_tpu_torch.parallel.gop",
        description="GOP-batched decode of independent IDR-led GOP streams, "
        "every frame's MD5 held to the serial numpy oracle's")
    ap.add_argument("streams", nargs="*", type=Path)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--devices", type=int, default=None,
                    help="devices to split the GOPs over (default: every "
                    "visible card; 1 with --device cpu)")
    ap.add_argument("--capture", nargs=2, type=Path, metavar=("GOP", "OUT"),
                    help="capture one GOP stream into OUT (pickle) and exit")
    a = ap.parse_args(argv)
    if a.capture:
        t0 = time.perf_counter()
        frames = _capture_gop(a.capture[0].read_bytes())
        tmp = a.capture[1].with_suffix(".tmp")
        tmp.write_bytes(pickle.dumps(frames))
        tmp.replace(a.capture[1])
        print(json.dumps({"frames": len(frames),
                          "seconds": time.perf_counter() - t0,
                          "self_ms": SP.self_ms_by_name(
                              frames[0]["spans"].spans)}))
        return 0
    if not a.streams:
        ap.error("no GOP streams")
    mesh = (make_mesh(["cpu"] * (a.devices or 1)) if a.device == "cpu"
            else make_mesh(a.devices))
    stats = {}
    dev, ser = decode_gops_sharded([p.read_bytes() for p in a.streams],
                                   mesh=mesh, verbose=True, stats=stats)
    ok = dev == ser and stats["checksum"] == stats["serial_checksum"]
    (rec,) = SP.calls(1)
    print(f"{len(a.streams)} GOPs, {stats['frames']} frames in "
          f"{stats['steps']} steps on {len(mesh)} {mesh[0].type} device(s): "
          f"{'bit-exact (MD5-compared)' if ok else 'MISMATCH'}; device "
          f"{stats['seconds'] * 1e3:.3f} ms; self ms by span "
          f"{json.dumps(SP.self_ms_by_name(rec.spans))}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
