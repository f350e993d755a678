"""The dependency chains of a stream's intra scans, from the host half alone:

    python tests/torch_scan_depth.py STREAM.evc [STREAM.evc ...]

Decodes each stream's syntax with the port's host `Decoder` (entropy,
derive and pack; no pixel is computed: the backend returns blank
pictures) and prints one line a frame: its scan CUs, and the chain the
persistent scan kernels walk one step after another -- for a Baseline
frame the longest chain of dependent CUs (`ops/intra.py`
`intra_dag_depth`, the K5 rule), for an EIPD frame its level count (K6).
Runs on the CPU, without JAX."""
from __future__ import annotations

import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent


def frames_packed(path):
    """Every frame's PackedFrame of the stream at `path`."""
    from xevd_tpu_torch import TorchPixelBackend
    from xevd_tpu_torch.host import NAL_UNIT_LENGTH_BYTE, Decoder, info
    from xevd_tpu_torch.ops.tables import PAD_C, PAD_L

    class PackOnly(TorchPixelBackend):
        def __init__(self):
            super().__init__(device="cpu")
            self.packed = []

        def decode_frame(self, job, sps, refp):
            pf = self.pack_frame(job, sps, refp)
            self.packed.append(pf.copy())   # detached from its slot
            h, w = pf.geom[:2]

            def blank(hh, ww, pad):
                return torch.zeros(hh + 2 * pad, ww + 2 * pad,
                                   dtype=torch.int16)
            if not pf.chroma:
                return blank(h, w, PAD_L), None, None
            return (blank(h, w, PAD_L), blank(h >> 1, w >> 1, PAD_C),
                    blank(h >> 1, w >> 1, PAD_C))

    backend = PackOnly()
    dec = Decoder(backend=backend)
    data = Path(path).read_bytes()
    pos = 0
    while pos + NAL_UNIT_LENGTH_BYTE <= len(data):
        ln, _, _ = info(data[pos:pos + 6])
        dec.decode(data[pos + 4:pos + 4 + ln])
        pos += 4 + ln
    dec._drain_pipeline()
    return backend.packed


def main(argv) -> int:
    sys.path.insert(0, str(REPO))
    from xevd_tpu_torch.ops import pack as PK
    from xevd_tpu_torch.ops.intra import intra_dag_depth

    for path in argv:
        for i, pf in enumerate(frames_packed(path)):
            df = PK.upload(pf, torch.device("cpu"))
            kind = "inter" if pf.refs else "intra"
            if pf.eipd:
                chain = f"{df.level_off.shape[0] - 1} levels"
            else:
                chain = f"depth {intra_dag_depth(df.icu, *pf.geom[2:])}"
            print(f"{Path(path).name} frame {i} ({kind}): "
                  f"{df.icu.shape[0]} scan CUs, {chain}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
