"""Device times of the loop-filter and output stages on whole pictures:
the Baseline luma deblock (K8: `ops/deblock.py` `deblock_luma`, both
passes in one launch; in a checkout without it, `deblock_pass` once a
pass), ADDB (`ops/addb.py` `addb_frame`), ALF (`ops/alf.py`
`alf_frame`), the SUCO-order chroma deblock (K10, `ops/deblock.py`
`chroma_ver_ordered`) and pad-expand (K14: `ops/recon.py` `pad_picture`,
one launch over Y, U and V; in a checkout without it, `pad` once a
plane).  On a synthetic 1080p 4:2:0 picture (random luma deblock maps,
and a GOP batch of 8 such luma areas; the smoke's ADDB maps; ALF at CTU
64 with 70 % of the CTU flags set; pad), and, given streams, on each
picture's own areas, maps, coefficients, flags and SUCO edge tables (K8
on every picture with the Baseline deblock, K10 on every picture that
has a SUCO table), pad on each stream's picture 0.  ALF is timed on the whole
picture, on its luma alone and on one chroma plane alone.  Each case
gives two times, both by CUDA graphs (every launch the stage makes and
whatever it allocates or copies, the wrapper's host work left out): the
mean of 100 replays of a graph of one stage call, and the mean a call of
20 replays of a graph of 20 calls -- a replay of a one-call graph lasts
at least the host's launch of the graph, some 5 us.  Each SUCO picture
also gets the host time of its pack (`ops/pack.py` `pack_frame`, the SUCO
edge replay and, where the checkout has it, the run table included):
[ms, the least of 5 packs; ms, their median].

    python tests/torch_loopfilter_times.py [ROOT [STREAM ...]]

ROOT is the checkout whose port and helpers are timed (this one by
default): the stage functions keep their signatures across the port's
versions (K10's run table and `pad_picture` are used where the checkout
has them), so two commits compare in one call on one card (run the
script on each in turns).  A STREAM, a Main stream with ADDB and ALF or
with SUCO (for example the smoke's config-3 and SUCO streams, cached
under tests/fixtures), adds its pictures; so does a Baseline stream
(the smoke's 1080p IPPP stream).  Prints the card (nvidia-smi
name and power limit), then one JSON object {case: [ms one-call graph,
ms a call in 20-call graphs]}.  Needs a CUDA device; imports no JAX."""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from torch_mc_times import graph_ms     # this script's directory


def both(torch, fn):
    """[ms by graphs of one call, ms a call in graphs of 20 calls]."""
    return [graph_ms(torch, fn), graph_ms(torch, fn, 20, 20)]


def synthetic(torch, H, dev, bd=8, h=1080, w=1920, log2_ctu=6):
    """(areas, addb maps, alf arguments) of a synthetic h x w picture on
    bordered planes, from H's numpy-seeded inputs."""
    from xevd_tpu_torch.ops.tables import BORDER
    rng = np.random.default_rng(650)
    areas = []
    for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        plane = H.bordered(rng, ph, pw, 0, 1 << bd)
        plane[BORDER:BORDER + ph, BORDER:BORDER + pw] = H.smooth_plane(
            rng, ph, pw, bd)
        areas.append(torch.from_numpy(plane).to(dev)[
            BORDER:BORDER + ph, BORDER:BORDER + pw])
    maps = [torch.from_numpy(H.addb_pars(rng, h // 4, w // 4, bd, n)).to(dev)
            for n in (4, 7)]
    cl, cc = H.alf_coefs(rng)
    S = 1 << log2_ctu
    on = (rng.random(-(-h // S) * -(-w // S)) < 0.7).astype(np.int32)
    alf = [torch.from_numpy(a).to(dev) for a in (cl, cc, on)]
    return areas, maps, alf + [h, w], log2_ctu, bd


def stage_times(torch, TA, TL, label, addb_areas, maps, alf_areas, alf_args,
                cfg, bd, out):
    """Time ADDB on `addb_areas` and ALF on `alf_areas` (whole picture,
    luma alone, the first filtered chroma plane alone) into out."""
    if addb_areas is not None:
        out[f"{label} addb_frame"] = both(
            torch, lambda: TA.addb_frame(*addb_areas, *maps, bd))
    if alf_areas is None:
        return
    en, log2_ctu, across = cfg
    parts = [("", en)]
    if en[0]:
        parts.append((" Y alone", (True, False, False)))
    for p in (1, 2):
        if en[p] and alf_areas[p] is not None:
            parts.append((f" {'YUV'[p]} alone", (False, p == 1, p == 2)))
            break
    for what, enables in parts:
        out[f"{label} alf_frame{what}"] = both(
            torch, lambda: TL.alf_frame(*alf_areas, *alf_args,
                                        (enables, log2_ctu, across), bd))


def pad_times(torch, TR, label, areas, h, w, chroma, out):
    """Time pad-expand of one picture's areas into new planes."""
    from xevd_tpu_torch.ops.tables import PAD_C, PAD_L
    if hasattr(TR, "pad_picture"):
        def call():
            TR.pad_picture(*areas, h, w, chroma)
    else:
        def call():
            TR.pad(areas[0], h, w, PAD_L)
            for a in areas[1:] if chroma else ():
                TR.pad(a, h >> 1, w >> 1, PAD_C)
    out[f"{label} pad"] = both(torch, call)


def luma_times(torch, TD, label, area, st_ver, st_hor, bd, out):
    """Time K8 on a luma area (or GOP batch of areas) with its maps."""
    if hasattr(TD, "deblock_luma"):
        def call():
            TD.deblock_luma(area, st_ver, st_hor, bd)
    else:
        def call():
            TD.deblock_pass("luma_ver", area, st_ver, bd)
            TD.deblock_pass("luma_hor", area, st_hor, bd)
    out[f"{label} deblock_luma"] = both(torch, call)


def synthetic_luma(torch, H, dev, G, bd=8, h=1080, w=1920):
    """(area, st_ver, st_hor): the luma area(s) of G bordered synthetic h x
    w pictures (G None: one) and random per-SCU maps (`strengths`)."""
    from xevd_tpu_torch.ops.tables import BORDER
    rng = np.random.default_rng(400)
    n = G or 1
    planes = np.stack([H.bordered(rng, h, w, 0, 1 << bd) for _ in range(n)])
    for p in planes:
        p[BORDER:BORDER + h, BORDER:BORDER + w] = H.smooth_plane(rng, h, w,
                                                                 bd)
    st = torch.from_numpy(H.strengths(rng, h // 4, w // 4, 2 * n)).to(dev)
    area = torch.from_numpy(planes).to(dev)[:, BORDER:BORDER + h,
                                            BORDER:BORDER + w]
    st_ver, st_hor = st[:n], st[n:]
    if G is None:
        return area[0], st_ver[0], st_hor[0]
    return area, st_ver, st_hor


def suco_times(torch, TD, label, areas, df, bd, out):
    """Time K10 on a picture's chroma areas and its own edge table (with
    the run table where the checkout ships one)."""
    runs = getattr(df, "suco_runs", None)
    kw = {} if runs is None else {"runs": runs}
    out[f"{label} chroma_ver_ordered"] = both(
        torch, lambda: TD.chroma_ver_ordered(areas[1], areas[2], df.suco_off,
                                             df.suco_edges, bd, **kw))


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_loopfilter_times: no CUDA device", file=sys.stderr)
        return 1
    root = Path(argv[0] if argv else Path(__file__).resolve().parent.parent)
    sys.path.insert(0, str(root.resolve()))
    import tests.torch_helpers as H
    from xevd_tpu_torch.ops import addb as TA
    from xevd_tpu_torch.ops import alf as TL
    from xevd_tpu_torch.ops import deblock as TD
    from xevd_tpu_torch.ops import pack as PK
    from xevd_tpu_torch.ops import recon as TR
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    out = {}
    areas, maps, alf_args, log2_ctu, bd = synthetic(torch, H, dev)
    stage_times(torch, TA, TL, "synthetic 1080p", areas, maps,
                [a.clone() for a in areas], alf_args,
                ((True, True, True), log2_ctu, True), bd, out)
    pad_times(torch, TR, "synthetic 1080p", areas, 1080, 1920, True, out)
    for G in (None, 8):
        luma_times(torch, TD, f"synthetic 1080p{f' G {G}' if G else ''}",
                   *synthetic_luma(torch, H, dev, G), 8, out)
    for stream in argv[1:]:
        name = Path(stream).stem
        for i, (job, sps, refp, pf) in enumerate(
                H.captured_frames(Path(stream), dev)):
            label = f"{name} picture {i}"
            addb_areas = alf_areas = None
            if pf.suco:
                t = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    PK.pack_frame(job, sps, refp)
                    t.append((time.perf_counter() - t0) * 1e3)
                out[f"{label} pack_frame host"] = [min(t), float(np.median(t))]
                suco_areas, df = H.frame_areas_before(pf, dev, "deblock")
                suco_times(torch, TD, label, suco_areas, df, pf.bd, out)
            if pf.deblock_on and not pf.addb:
                luma_areas, df = H.frame_areas_before(pf, dev, "deblock")
                luma_times(torch, TD, label, luma_areas[0], df.dbst[0],
                           df.dbst[1], pf.bd, out)
            if i == 0:
                pad_areas, df = H.frame_areas_before(pf, dev, "alf")
                pad_times(torch, TR, label, pad_areas, *pf.geom[:2],
                          pf.chroma, out)
            if pf.addb:
                addb_areas, df = H.frame_areas_before(pf, dev, "deblock")
            if pf.alf is not None:
                alf_areas, df = H.frame_areas_before(pf, dev, "alf")
            if addb_areas is None and alf_areas is None:
                continue
            stage_times(torch, TA, TL, label, addb_areas,
                        (df.addb_l, df.addb_c), alf_areas,
                        (df.alf_l, df.alf_c, df.alf_on) + pf.geom[:2],
                        pf.alf, pf.bd, out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
