"""The stage-diff tool's knock-outs (`python -m xevd_tpu_torch.diff
--stages`), applied alike to a frame's job on the port's side and on the
numpy oracle's (tests/torch_reference.py --knockout).  numpy alone: the
oracle's process imports this module and nothing of the port's device
code."""
from __future__ import annotations

import numpy as np

# the knock-outs of tools/stage_diff.py (deblocking off) and
# tools/stage_diff2.py (its modes), in the order --stages tries them
KNOCKOUTS = ("nodb", "nover", "nohor", "noluma")
# mode -> (Baseline strength maps zeroed, ADDB map, its directions whose
# bs is zeroed: 0 vertical edges, 1 horizontal)
_ZEROED = {
    "nodb": (("db_ver_y", "db_hor_y", "db_ver_u", "db_hor_u", "db_ver_v",
              "db_hor_v"), None, ()),
    "nover": (("db_ver_u", "db_ver_v"), "addb_chroma", (0,)),
    "nohor": (("db_hor_u", "db_hor_v"), "addb_chroma", (1,)),
    "noluma": (("db_ver_y", "db_hor_y"), "addb_luma", (0, 1)),
}


def knock_out(job, mode: str):
    """Apply knock-out `mode` ("none" or one of KNOCKOUTS) to a frame's
    job (`host/derive.py` FrameJob, or `xevd_tpu`'s) in place, before its
    pixels are computed.  Maps are replaced, never written into: with
    deblocking off the decoder shares one zero map among them."""
    if mode == "none":
        return
    if mode not in _ZEROED:
        raise ValueError(f"knock-out {mode!r}: none or one of {KNOCKOUTS}")
    names, addb, dirs = _ZEROED[mode]
    for name in names:
        m = getattr(job, name, None)
        if m is not None:
            setattr(job, name, np.zeros_like(m))
    if mode == "nodb":
        job.fs.sh.deblocking_filter_on = 0
        job.addb_luma = job.addb_chroma = None
    elif getattr(job, addb, None) is not None:
        m = np.array(getattr(job, addb))
        m[list(dirs), ..., 0] = 0
        setattr(job, addb, m)
