"""Syntax-element trace harness for bit-exactness debugging.

The reference's compile-time ENC_DEC_TRACE system (ref:
src_base/xevd_def.h:114-157) writes one numbered line per syntax element;
diffing two traces localizes a divergence to the exact element.  This is
the runtime equivalent for the Python entropy path:

    python -m xevd_tpu.app -i in.evc -o out.yuv --trace trace.txt

or programmatically via `trace.init(path)`.  Levels:
  - CU/split events are always traced when enabled (mirrors the reference's
    entropy-tree traces, ref: src_base/xevd.c:775-786,937-973)
  - per-bin SBAC tracing (TRACE_BIN analog) with init(path, bins=True)

Tracing forces the pure-Python entropy engine (the native C engine has no
hooks) — it is a debug tool, not a decode path.
"""
from __future__ import annotations

_fp = None
_bins = False
_cnt = 0


def init(path: str, bins: bool = False):
    global _fp, _bins, _cnt
    _fp = open(path, "w")
    _bins = bins
    _cnt = 0


def close():
    global _fp
    if _fp:
        _fp.close()
        _fp = None


def enabled() -> bool:
    return _fp is not None


def bins_enabled() -> bool:
    return _fp is not None and _bins


def line(s: str):
    global _cnt
    _fp.write(f"{_cnt}\t{s}\n")
    _cnt += 1


def poc(poc_val: int):
    if _fp:
        line(f"===== POC {poc_val} =====")
