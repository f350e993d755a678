"""The cost of the port's span recorder (xevd_tpu_torch/spans.py): ns a
span recorded into an open record, against the same loop with the
recorder's calls removed, best of 5 loops of N.

    python tests/torch_span_cost.py [N]

Prints the host's CPU model and one JSON object.  Needs no card."""
import json
import platform
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from xevd_tpu_torch import spans as SP  # noqa: E402


def cost(n: int = 100_000) -> dict:
    """{"ns_a_span", "loop_ns_with", "loop_ns_without"}: ns a loop step
    with a span recorded, and without."""
    def spans():
        with SP.record():
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with SP.span("cost"):
                    pass
            return time.perf_counter_ns() - t0

    def bare():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            pass
        return time.perf_counter_ns() - t0
    with_ns = min(spans() for _ in range(5)) / n
    bare_ns = min(bare() for _ in range(5)) / n
    return {"ns_a_span": with_ns - bare_ns, "loop_ns_with": with_ns,
            "loop_ns_without": bare_ns}


def cpu_model() -> str:
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


if __name__ == "__main__":
    print(cpu_model())
    print(json.dumps(cost(int(sys.argv[1]) if len(sys.argv) > 1
                          else 100_000)))
