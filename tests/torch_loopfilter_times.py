"""Device times of the loop-filter stages ADDB (`ops/addb.py` `addb_frame`)
and ALF (`ops/alf.py` `alf_frame`) on whole pictures: a synthetic 1080p
4:2:0 picture (the smoke's ADDB maps; ALF at CTU 64 with 70 % of the CTU
flags set), and, given a stream, each of its pictures' own areas, maps,
coefficients and flags.  ALF is timed on the whole picture, on its luma
alone and on one chroma plane alone.  Each case gives two times, both by
CUDA graphs (every launch the stage makes and whatever it allocates or
copies, the wrapper's host work left out): the mean of 100 replays of a
graph of one stage call, and the mean a call of 20 replays of a graph of
20 calls -- a replay of a one-call graph lasts at least the host's launch
of the graph, some 5 us.

    python tests/torch_loopfilter_times.py [ROOT [STREAM]]

ROOT is the checkout whose port and helpers are timed (this one by
default): both stage functions keep their signatures across the port's
versions, so two commits compare in one call on one card (run the script
on each in turns).  STREAM, a Main stream with ADDB and ALF (for example
the smoke's config-3 stream, written by `tests/torch_reference.py
--streams`), adds its pictures.  Prints the card (nvidia-smi name and
power limit), then one JSON object {case: [ms one-call graph, ms a call
in 20-call graphs]}.  Needs a CUDA device; imports no JAX."""
import json
import subprocess
import sys
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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    out = {}
    areas, maps, alf_args, log2_ctu, bd = synthetic(torch, H, dev)
    stage_times(torch, TA, TL, "synthetic 1080p", areas, maps,
                [a.clone() for a in areas], alf_args,
                ((True, True, True), log2_ctu, True), bd, out)
    if len(argv) > 1:
        for i, (_, _, _, pf) in enumerate(H.captured_frames(Path(argv[1]),
                                                            dev)):
            addb_areas = alf_areas = None
            if pf.addb:
                addb_areas, df = H.frame_areas_before(pf, dev, "deblock")
            if pf.alf is not None:
                alf_areas, df = H.frame_areas_before(pf, dev, "alf")
            if addb_areas is None and alf_areas is None:
                continue
            stage_times(torch, TA, TL, f"picture {i}", addb_areas,
                        (df.addb_l, df.addb_c), alf_areas,
                        (df.alf_l, df.alf_c, df.alf_on) + pf.geom[:2],
                        pf.alf, pf.bd, out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
