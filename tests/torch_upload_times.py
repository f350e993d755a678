"""Host and device times of a frame's upload from a staging slot
(ops/pack.py `_copies`, ops/staging.py) on the card, part by part:

    python tests/torch_upload_times.py [ROOT]

For a payload and coefficient buffer of a 1080p config-3 picture's size
(20 MB and 6.3 MB) and of a CIF picture's (0.4 MB and 0.3 MB): the host
time of each part of the upload -- `is_pinned` on the slot's two views,
the two device allocations, the two non_blocking copies' issue, the
event's record -- and of the whole `_copies`, each the median of 50 calls
with the stream idle; the whole `_copies` again behind 50 ms of
`torch.cuda._sleep` on the stream (a host time near the idle one shows
that the issue does not wait for the card); the copies' device time by
events; and the blocking copy of the same bytes from pageable memory, as
the parent's upload made it.  ROOT: the checkout whose port is timed
(default: this one).  Prints the card's name and power limit, then one
JSON line."""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else
            Path(__file__).resolve().parent.parent).resolve()
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from xevd_tpu_torch.ops import pack as PK  # noqa: E402
from xevd_tpu_torch.ops.staging import HostStaging  # noqa: E402

REPS = 50
SIZES = {"config3": (5_000_000, 3_133_440), "cif": (100_000, 152_064)}


def host_ms(fn, reps=REPS):
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_upload_times: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev)
    out = {}
    for name, (words, coefs) in SIZES.items():
        slot = HostStaging(dev, 1).acquire(words, coefs)
        slot.payload_np[:words] = np.arange(words, dtype=np.int32)
        slot.coefs_np[:coefs] = 7
        payload, coef = slot.payload_np[:words], slot.coefs_np[:coefs]
        srcs = slot.sources(words, coefs)
        dsts = [torch.empty(s.shape, dtype=s.dtype, device=dev)
                for s in srcs]

        def whole():
            PK._copies(payload, coef, slot, dev)

        def copies():
            for d, s in zip(dsts, srcs):
                d.copy_(s, non_blocking=True)

        def behind_sleep():
            torch.cuda._sleep(100_000_000)          # some 50 ms
            t0 = time.perf_counter()
            whole()
            return (time.perf_counter() - t0) * 1e3
        whole()
        torch.cuda.synchronize()
        r = {"bytes": words * 4 + coefs * 2,
             "is_pinned_ms": host_ms(lambda: [s.is_pinned() for s in srcs]),
             "alloc_ms": host_ms(lambda: [torch.empty(
                 s.shape, dtype=s.dtype, device=dev) for s in srcs]),
             "copy_issue_ms": host_ms(copies),
             "event_record_ms": host_ms(lambda: slot.event.record(stream)),
             "copies_host_ms": host_ms(whole)}
        r["copies_host_ms_behind_sleep"] = statistics.median(
            behind_sleep() for _ in range(5))
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        dev_ms = []
        for _ in range(20):
            ev[0].record()
            copies()
            ev[1].record()
            ev[1].synchronize()
            dev_ms.append(ev[0].elapsed_time(ev[1]))
        r["copies_device_ms"] = statistics.median(dev_ms)
        pageable = (torch.from_numpy(payload.copy()),
                    torch.from_numpy(coef.copy()))
        r["pageable_blocking_ms"] = host_ms(
            lambda: [p.to(dev) for p in pageable], reps=20)
        out[name] = r
        print(f"{name}: {json.dumps(r)}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
