"""Where and how the native host engine (`native/*.c`) is built for this
host, and the port's own host C (`xevd_tpu_torch/native/*.c`: the GOP
batch's intra scan order, ops/intra.py `intra_depths_host`) beside it.

`host/native.py` loads the library from `library_path()`, under
build/xevd_tpu_torch/native/<key>/libevc_entropy.so (gitignored), and
builds it there at first use.  <key> hashes the compiler command, the
contents of every `native/*.c` and `native/*.h` (the engine's sources and
`evc_main_tables.h`) and this host's CPU: the `model name` and `flags`
lines of /proc/cpuinfo.  `-march=native` code runs only on a CPU with the
instructions it was built for, so a tree copied to another host builds a
library of its own instead of loading one that dies there with SIGILL.
The committed `native/libevc_entropy.so` is never loaded.

Many processes (pytest workers) may build at once: each compiles to a
file name of its own and renames it into place (`os.replace`, atomic), so
no process loads a partly written library."""
from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

# the compiler command of the engine, less the sources and the output
COMMAND = ("cc", "-O3", "-march=native", "-shared", "-fPIC")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "xevd_tpu_torch" / "native"
LIB_NAME = "libevc_entropy.so"


def cpu_id() -> str:
    """The `model name` and `flags` lines of /proc/cpuinfo (every distinct
    one, sorted), or the platform's machine and processor names where
    there is no /proc/cpuinfo."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return f"{platform.machine()} {platform.processor()}"
    keep = {line.strip() for line in text.splitlines()
            if line.split(":")[0].strip() in ("model name", "flags")}
    return "\n".join(sorted(keep))


def library_path(src_dir: Path, cpu: str | None = None,
                 lib_name: str = LIB_NAME) -> Path:
    """This host's path for the library `lib_name` (the engine's by
    default) whose sources are in `src_dir` (`cpu`: the CPU description
    to key on, default `cpu_id()`)."""
    h = hashlib.sha256()
    h.update(" ".join(COMMAND).encode())
    for p in sorted(Path(src_dir).glob("*.[ch]")):
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    h.update((cpu_id() if cpu is None else cpu).encode())
    return BUILD_DIR / h.hexdigest()[:16] / lib_name


def build_library(cmd: list, check: bool = True):
    """Run the compiler command `cmd`, whose `-o` argument names the
    library, so that the library appears at once and whole: the compiler
    writes a file of this process's own beside it, which then replaces
    the library."""
    cmd = list(cmd)
    i = cmd.index("-o") + 1
    out = Path(cmd[i])
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.{threading.get_ident()}")
    cmd[i] = str(tmp)
    try:
        subprocess.run(cmd, check=check)
        if tmp.exists():
            os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
