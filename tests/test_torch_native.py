"""The port's native host engine is built for the host it runs on
(xevd_tpu_torch/native_build.py), never loaded from the committed
native/libevc_entropy.so, which was built `-march=native` on another host
and dies with SIGILL (rc 132) on a CPU without its instructions: the Main
derive path of the gate cases m_off_p, m_btt_p, m_eipd_p, m_admvp_p,
m_mmvd_p, m_admvp_ra and m_pocs_ra did on an AMD EPYC."""
import subprocess
import sys

from xevd_tpu_torch import native_build as NB
from xevd_tpu_torch.host import native as PN

from .conftest import REPO, make_stream
from .test_torch_host_copy import HOST, _edited, _split

COMMITTED = REPO / "native" / "libevc_entropy.so"


def test_loader_resolves_a_build_of_this_host():
    """The library path lies under build/, keyed on this host's CPU and the
    sources, and is not the committed library."""
    assert PN._SO.is_relative_to(REPO / "build" / "xevd_tpu_torch" / "native")
    assert PN._SO != COMMITTED
    assert PN._SO == NB.library_path(REPO / "native")
    assert PN.get_lib() is not None and PN._SO.exists()


def test_key_follows_cpu_and_sources(tmp_path):
    src = REPO / "native"
    assert NB.library_path(src, cpu="a") != NB.library_path(src, cpu="b")
    for p in src.glob("*.[ch]"):
        (tmp_path / p.name).write_bytes(p.read_bytes())
    assert NB.library_path(tmp_path) == NB.library_path(src)
    (tmp_path / "evc_main_tables.h").write_text("/* changed */\n")
    assert NB.library_path(tmp_path) != NB.library_path(src)


_DECODE = """
import sys
from pathlib import Path
from xevd_tpu_torch.app import main
from xevd_tpu_torch.host import native
assert main(["-i", sys.argv[1], "-o", sys.argv[2], "--output-bit-depth", "10",
             "-v", "0", "--device", "cpu"]) == 0
maps = Path("/proc/self/maps").read_text()
assert str(native._SO) in maps, "the host's own build is not loaded"
assert "native/libevc_entropy.so" not in maps, "the committed library is"
"""


def test_main_p_stream_decodes_in_a_fresh_process(fixtures_dir, tmp_path):
    """m_off_p (tests/test_main_profile.py), a Main IPPP stream through
    the native Main derive, decodes in a fresh interpreter, which maps
    this host's build and not the committed library."""
    stream = make_stream(fixtures_dir / "torch_main_m_off_p.evc", 176, 144,
                         3, 33, 102, "IPPP", profile=1)
    r = subprocess.run([sys.executable, "-c", _DECODE, str(stream),
                        str(tmp_path / "t.yuv")], cwd=REPO,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    assert (tmp_path / "t.yuv").stat().st_size == 3 * 176 * 144 * 3


_BUILD = """
import sys
from pathlib import Path
from xevd_tpu_torch.host import native
native._SO = Path(sys.argv[1])
lib = native.get_lib()
assert lib is not None and lib.evc_main_derive is not None
print("loaded", native._SO)
"""


def test_processes_that_build_at_once_all_load(tmp_path):
    """Two processes build the same (new) library path at the same time:
    each loads a whole, working library and no partial file is left."""
    out = tmp_path / "key" / NB.LIB_NAME
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(out)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-3000:]
        assert stdout.startswith("loaded")
    assert [q.name for q in out.parent.iterdir()] == [NB.LIB_NAME]


def test_host_copy_lists_the_build_lines():
    """The copy's docstring names the lines that differ from
    xevd_tpu/native.py (test_torch_host_copy.py holds them equal
    otherwise), the per-host build among them."""
    doc, _ = _split(HOST / "native.py")
    listed = _edited(doc)
    assert {'_SO = library_path(_REPO / "native")', "build_library(",
            "[*COMMAND,"} <= listed
    assert not any("libevc_entropy.so" in line for line in listed)
