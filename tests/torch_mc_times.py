"""Device times of the MC kernel (csrc/mc.cu) on the synthetic MC cases that
chip_smoke.py holds to the plain version: every (plane, case, bit depth,
taps) table of `mc_size_case`, the 1080p frame of `mc_case` at 8 and 10
bits, and the every-class frame of `mc_class_case` where the checkout has
it.  Each time is the mean of 100 replays of a CUDA graph that captured
one `mc_all` call, the planes' zeroing included.

    python tests/torch_mc_times.py [ROOT]

ROOT is the checkout whose port and helpers are timed (this one by
default), so two commits compare in one call on one card: run the
script on each in turns.  Prints the card (nvidia-smi name and power
limit), then one JSON object {case: ms}.  Needs a CUDA device; imports
no JAX."""
import json
import subprocess
import sys
from pathlib import Path


def graph_ms(torch, fn, reps=100, calls=1):
    """Mean device ms of one fn() call over `reps` replays of a CUDA graph
    of `calls` calls (allocations made outside the capture first): the
    wrapper's host work (argument checks, ctypes) is left out.  With one
    call a replay lasts at least the host's launch of the graph, some 5
    us; `calls` calls a graph spread that over them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
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
    return t0.elapsed_time(t1) / (reps * calls)


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_mc_times: no CUDA device", file=sys.stderr)
        return 1
    root = Path(argv[0] if argv else Path(__file__).resolve().parent.parent)
    sys.path.insert(0, str(root.resolve()))
    import tests.torch_helpers as H
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    cases = []
    for bd in (8, 10):
        for main_taps in (False, True):
            for is_luma in (True, False):
                for case in range(4):
                    cases.append(H.mc_size_case(dev, is_luma, case, bd,
                                                seed=250,
                                                main_taps=main_taps))
        cases.append(H.mc_case(dev, 1080, 1920, bd, seed=260))
        if hasattr(H, "mc_class_case"):
            for main_taps in (False, True):
                cases.append(H.mc_class_case(dev, bd, main_taps, seed=270))
    out = {}
    for c in cases:
        if H.compare(c) != 0:
            raise AssertionError(f"{c.shape}: kernel != plain version")
        out[c.shape] = graph_ms(torch, c.kernel)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
