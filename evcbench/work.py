"""The least time the card could take for each bytes-bound batched kernel
of a GOP job: bytes and operations from the job's own tables, against the
card's peaks.  Frozen copies of the `*_work` functions of
tests/torch_helpers.py (itdq_work, mc_work, deblock_work,
deblock_luma_work, pad_work) and of chip_smoke.py's peaks, with recon's
count made here for all three planes; the tables' column numbers and the
picture's padding are read from the program (xevd_tpu_torch/ops/pack.py,
host/tables.py): its data format.

Each input byte is counted once when read and each output byte once when
written; where the work depends on the data, what these inputs need."""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet: HBM3 bytes/s; integer operations/s taken at
# the scalar (non-tensor) float32 FMA rate counted as two operations.  That
# is an assumed, deliberately high peak: the int32 issue rate is lower, so
# the operations term never overstates a kernel's bound.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# the trace's kernel name of each bytes-bound batched kernel
KERNELS = {"gop_itdq": "itdq_kernel", "gop_mc": "mc_kernel",
           "gop_recon": "_recon_kernel", "gop_deblock_luma": "luma_kernel",
           "gop_deblock_chroma_ver": "chroma_ver_kernel",
           "gop_deblock_chroma_hor": "chroma_hor_kernel",
           "gop_pad": "pad_kernel"}


def itdq_work(t, PK):
    t = t.astype(np.int64)
    w, h = 1 << t[:, PK.TU_LOG2W], 1 << t[:, PK.TU_LOG2H]
    n = w * h
    return int(4 * n.sum() + t.size * 4), int((2 * n * (w + h) + 4 * n).sum())


def mc_work(t, PK):
    t = t.astype(np.int64)
    luma = t[:, PK.MC_PLANE] == 0
    ntap = np.where(luma, 8, 4)
    planes = np.where(luma, 1, 2)
    cx, cy = (t[:, PK.MC_CASE] & 1) != 0, (t[:, PK.MC_CASE] & 2) != 0
    w, h = t[:, PK.MC_W], t[:, PK.MC_H]
    win = (w + cx * (ntap - 1)) * (h + cy * (ntap - 1))
    n = w * h
    taps = np.maximum(1, 2 * ntap * (cx.astype(np.int64) + cy))
    return (int((planes * (2 * win + 5 * n)).sum() + t.size * 4),
            int((planes * n * taps).sum()))


def deblock_work(kind, st):
    s = st > 0
    luma = kind.startswith("luma")
    on = (s[..., 1:] if kind.endswith("ver") else s[..., 1:, :]).sum() * (
        4 if luma else 2)
    return int(on * (16 if luma else 12) + s.size * 4), int(on * 20)


def deblock_luma_work(st_ver, st_hor):
    m = [st_ver, st_hor]
    shape = st_ver.shape
    v, h = ((x > 0).copy() for x in m)
    v[..., 0] = False
    h[..., 0, :] = False
    hs, ws = shape[-2:]
    rows = np.zeros(shape[:-2] + (hs + 1, ws + 1, 2), np.int64)
    cols = np.zeros_like(rows)
    rows[..., 1:, :ws, 0] = v
    rows[..., :hs, :ws, 1] = v
    cols[..., :hs, 1:, 0] = h
    cols[..., :hs, :ws, 1] = h
    nr, nc = 2 * rows.sum(-1), 2 * cols.sum(-1)
    samples = int((4 * nr + 4 * nc - nr * nc).sum())
    lines = int(v.sum() + h.sum()) * 4
    return samples * 4 + sum(x.size * 4 for x in m), lines * 20


def pad_work(G, h, w, chroma, pad_l, pad_c):
    n = h * w + (h + 2 * pad_l) * (w + 2 * pad_l)
    if chroma:
        n += 2 * ((h >> 1) * (w >> 1)
                  + ((h >> 1) + 2 * pad_c) * ((w >> 1) + 2 * pad_c))
    return 2 * G * n, 0


def recon_work(G, shp_y, shp_c, predicted):
    """Recon over a step's three planes: the int16 residual read and the
    int16 picture written; with a prediction, the int32 prediction and the
    int8 count read too (U and V share one count, counted once)."""
    ny = G * int(np.prod(shp_y))
    nc = G * int(np.prod(shp_c)) if shp_c else 0
    if predicted:
        return 9 * ny + 9 * nc + 8 * nc, 6 * (ny + 2 * nc)
    return 4 * (ny + 2 * nc), 2 * (ny + 2 * nc)


def _table(pf, name, ncol):
    if name not in pf.layout:
        return np.zeros((0, ncol), np.int32)
    off, shape = pf.layout[name]
    return pf.payload[off:off + int(np.prod(shape))].reshape(shape)


def bound_seconds(nbytes: int, ops: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S)


def job_bounds(caps) -> dict:
    """{kernel: the least seconds of its launches in one job of every GOP
    of `caps`}, step by step as the entry batches them (step t holds frame
    t of each GOP that long); per step the kernel's bytes and operations
    summed over its frames."""
    from xevd_tpu_torch.host import tables as T
    from xevd_tpu_torch.ops import pack as PK
    out = {k: 0.0 for k in KERNELS}
    for t in range(max(len(c) for c in caps)):
        frames = [c[t]["pack"] for c in caps if len(c) > t]
        f0 = frames[0]
        h, w = f0.geom[:2]
        tus = np.concatenate([_table(f, "tus", PK.TU_COLS) for f in frames])
        mc = np.concatenate([_table(f, "mc", 10) for f in frames])
        work = {"gop_itdq": itdq_work(tus, PK),
                "gop_recon": recon_work(len(frames), f0.shp_y, f0.shp_c,
                                        mc.shape[0] > 0),
                "gop_pad": pad_work(len(frames), h, w, f0.chroma,
                                    T.PIC_PAD_SIZE_L, T.PIC_PAD_SIZE_C)}
        if mc.shape[0]:
            work["gop_mc"] = mc_work(mc, PK)
        if f0.deblock_on:
            st = np.stack([_table(f, "dbst", 0) for f in frames])
            work["gop_deblock_luma"] = deblock_luma_work(st[:, 0], st[:, 1])
            ver = [deblock_work("chroma_ver", st[:, k]) for k in (2, 4)]
            hor = [deblock_work("chroma_hor", st[:, k]) for k in (3, 5)]
            work["gop_deblock_chroma_ver"] = tuple(map(sum, zip(*ver)))
            work["gop_deblock_chroma_hor"] = tuple(map(sum, zip(*hor)))
        for k, (b, o) in work.items():
            out[k] += bound_seconds(b, o)
    return out
