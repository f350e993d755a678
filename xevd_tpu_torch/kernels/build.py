"""Build the CUDA kernels of `xevd_tpu_torch/csrc` at first use and bind
them with ctypes.

`nvcc` compiles every `csrc/*.cu` for sm_90a, one process per source, all
started together, and links the objects into one shared library with a
plain C interface under `build/xevd_tpu_torch/` (gitignored).  No PyTorch
header is included, so the build takes seconds, not minutes.  A missing
`nvcc`, a failed build or a failed launch raises; nothing falls back.

Launch counts: every wrapper calls `count(name)` where it launches its
kernel, and nowhere else, so a run can show which kernels its path used."""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "xevd_tpu_torch"
SOURCES = ("itdq.cu", "intra.cu", "deblock.cu", "mc.cu", "intra_main.cu",
           "addb.cu", "alf.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (every pointer and the stream are
# void*, every scalar int); each returns cudaGetLastError().
SIGNATURES = {
    "xevd_itdq": (_P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _P, _I, _P, _P,
                  _I, _I, _P),
    "xevd_intra_scan": (_P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _P),
    "xevd_deblock_luma_ver": (_P, _I, _I, _I, _P, _I, _P),
    "xevd_deblock_luma_hor": (_P, _I, _I, _I, _P, _I, _P),
    "xevd_deblock_chroma_ver": (_P, _I, _I, _I, _P, _I, _P),
    "xevd_deblock_chroma_hor": (_P, _I, _I, _I, _P, _I, _P),
    "xevd_mc": (_P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I,
                _P, _P, _I, _P),
    "xevd_intra_scan_wave": (_P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _I,
                             _P, _I, _I, _P),
    "xevd_chroma_ver_ordered": (_P, _P, _I, _I, _P, _P, _I, _P),
    "xevd_addb_luma_ver": (_P, _I, _I, _I, _P, _I, _I, _I, _P),
    "xevd_addb_luma_hor": (_P, _I, _I, _I, _P, _I, _I, _I, _P),
    "xevd_addb_chroma_ver": (_P, _I, _I, _I, _P, _I, _I, _I, _P),
    "xevd_addb_chroma_hor": (_P, _I, _I, _I, _P, _I, _I, _I, _P),
    "xevd_alf_luma": (_P, _I, _P, _I, _I, _I, _I, _P, _P, _I, _I, _P),
    "xevd_alf_chroma": (_P, _I, _P, _I, _I, _I, _I, _P, _P, _I, _I, _P),
}

launch_counts = {"itdq": 0, "recon": 0, "pad": 0, "intra_scan": 0,
                 "deblock_luma_ver": 0, "deblock_luma_hor": 0,
                 "deblock_chroma_ver": 0, "deblock_chroma_hor": 0, "mc": 0,
                 "intra_scan_wave": 0, "chroma_ver_ordered": 0,
                 "addb_luma_ver": 0, "addb_luma_hor": 0,
                 "addb_chroma_ver": 0, "addb_chroma_hor": 0, "alf_luma": 0,
                 "alf_chroma": 0}

_LIB = None
build_seconds = None


def count(name: str):
    launch_counts[name] += 1


def reset_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of xevd_tpu_torch cannot be built")


def _run(cmds):
    """Run the commands in parallel; raise with the output of the first
    that fails.  Returns the outputs in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(c)}\n{o}")
    return outs


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into build/xevd_tpu_torch/libxevd_kernels.so;
    returns the library path.  `verbose` adds `-Xptxas -v` and prints the
    register and shared-memory use of every kernel."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / "libxevd_kernels.so"
    # build under private names, then rename: a process that loads the
    # library never sees a half-written file
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    tmp = out.with_name(f"libxevd_kernels.{tag}.so")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        outs = _run([[nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose
                                           else ()),
                      "-c", "-o", str(o), str(CSRC / s)]
                     for s, o in zip(SOURCES, objs)])
        _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, out)
    if verbose:
        print("".join(outs))
    return out


def _stale(so: Path) -> bool:
    if not so.exists():
        return True
    mt = so.stat().st_mtime
    return any(mt < (CSRC / s).stat().st_mtime for s in SOURCES)


def lib() -> ctypes.CDLL:
    """The loaded kernel library; built on first use unless this checkout
    already holds a build newer than every source."""
    global _LIB
    if _LIB is None:
        so = BUILD_DIR / "libxevd_kernels.so"
        if _stale(so):
            so = build()
        cdll = ctypes.CDLL(str(so))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = cdll
    return _LIB


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, dtype: torch.dtype, ndim: int,
            contiguous: bool = False, rows_contiguous: bool = False):
    """Check one kernel operand: a CUDA tensor of `dtype` and `ndim`
    dimensions; `contiguous` asks for a dense tensor, `rows_contiguous` for
    unit stride along the last dimension (a 2-D view with a row pitch)."""
    if not t.is_cuda:
        raise ValueError(f"kernel operand on {t.device}, not on a CUDA device")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"kernel operand is {t.dtype} {tuple(t.shape)}, "
                         f"wants {dtype} with {ndim} dimensions")
    if contiguous and not t.is_contiguous():
        raise ValueError("kernel operand must be contiguous")
    if rows_contiguous and t.stride(-1) != 1:
        raise ValueError("kernel operand must have unit stride along rows")
