"""Device times of the Baseline luma deblock (K8) in three designs on the
same inputs: the port's `luma_kernel` (`ops/deblock.py` `deblock_luma`: a
thread a shifted 4x4 block, its samples in registers) and the two of
tests/torch_luma_variants.cu ("pairs": 8-byte words, a block's vertical
edge across two lanes by shuffles; "tile": a CTA stages 8 x 64 blocks in
shared memory with 16-byte loads), each first held to `luma_blocks_ref`
in 5 launches.  Cases: 1080p luma areas of bordered planes with smooth
samples and maps of each kind of `luma_maps`, and a GOP batch of 8 areas
with random maps.  Each time is by CUDA-graph replays: [ms of a one-call
graph, ms a call in 20-call graphs].

    python tests/torch_luma_variants.py

Builds the .cu with nvcc (sm_90a) into build/luma_variants/ (gitignored).
Prints the card (nvidia-smi name and power limit), then one JSON object
{case: {design: [ms, ms]}}.  Needs a CUDA device; imports no JAX."""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

from torch_mc_times import graph_ms     # this script's directory

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CASES = [(maps, None) for maps in ("random", "all", "zero", "ver", "hor")]
CASES.append(("random", 8))


def build():
    """The variants' library, built from tests/torch_luma_variants.cu."""
    sys.path.insert(0, str(ROOT))
    from xevd_tpu_torch.kernels import build as K
    out = ROOT / "build" / "luma_variants"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libluma_variants.so"
    subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o", str(so),
                    str(HERE / "torch_luma_variants.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.luma_variant.argtypes = (I, P, I, I, I, P, P, I, I, L, L, L, P)
    lib.luma_variant.restype = I
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_luma_variants: no CUDA device", file=sys.stderr)
        return 1
    lib = build()
    import torch_helpers as H
    from xevd_tpu_torch.ops import deblock as TD
    from xevd_tpu_torch.ops.tables import BORDER
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    hs, ws = 270, 480
    h, w = 4 * hs, 4 * ws
    out = {}
    for maps, G in CASES:
        rng = np.random.default_rng(400)
        n = G or 1
        planes = torch.from_numpy(np.stack(
            [H._padded(rng, h, w, 8) for _ in range(n)])).to(dev)
        st_ver, st_hor = (torch.from_numpy(np.stack(m)).to(dev) for m in zip(
            *(H.luma_maps(rng, maps, hs, ws) for _ in range(n))))
        want = planes.clone()
        TD.luma_blocks_ref(want[:, BORDER:BORDER + h, BORDER:BORDER + w],
                           st_ver, st_hor, 8)
        x = planes.clone()
        area = x[:, BORDER:BORDER + h, BORDER:BORDER + w]
        one = G is None

        def port():
            TD.deblock_luma(area[0] if one else area,
                            st_ver[0] if one else st_ver,
                            st_hor[0] if one else st_hor, 8)

        def variant(design):
            def call():
                err = lib.luma_variant(
                    design, area.data_ptr(), area.stride(1), h, w,
                    st_ver.data_ptr(), st_hor.data_ptr(), 8, n,
                    area.stride(0), st_ver.stride(0), st_hor.stride(0),
                    torch._C._cuda_getCurrentRawStream(dev.index))
                if err:
                    raise RuntimeError(f"luma_variant {design}: CUDA error "
                                       f"{err}")
            return call
        case = f"{f'G {G} x ' if G else ''}{h}x{w} {maps} maps"
        out[case] = {}
        for name, call in (("port", port), ("pairs", variant(0)),
                           ("tile", variant(1))):
            for _ in range(5):
                x.copy_(planes)
                call()
                torch.cuda.synchronize()
                if not torch.equal(x, want):
                    raise AssertionError(f"{name} != luma_blocks_ref on "
                                         f"{case}")
            out[case][name] = [graph_ms(torch, call),
                               graph_ms(torch, call, 20, 20)]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
