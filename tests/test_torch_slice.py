"""The PyTorch port's Baseline all-intra slice end to end, on the CPU.

Each stream is decoded by the torch backend (plain PyTorch versions) under
the port's own `Decoder` (`xevd_tpu_torch.host`), and by the numpy oracle
backend under `xevd_tpu`'s; the written YUV must be equal byte for byte,
and equal frame by frame to the JAX backend's decode, whose MD5s
tests/torch_jax_reference.py stores (`assert_backends_agree`, which the
inter-slice files test_torch_inter_p.py and test_torch_inter_ra.py and
the Main files test_torch_main_*.py share), so every case also holds the
host copy equal to its original.  Streams the port does not cover are
refused."""
import subprocess
import sys

import numpy as np
import pytest

from xevd_tpu_torch import UnsupportedStream

from .conftest import REPO, make_stream
from .torch_helpers import one_torch_thread, use_port_native_library
from .torch_jax_reference import assert_equals_jax

CASES = [
    # name, w, h, frames, qp, seed, gop, bd (tests/test_golden.py:20-24)
    ("i64", 64, 64, 1, 30, 1, "I", 8),
    ("i64_qp5", 64, 64, 1, 5, 2, "I", 8),
    ("i64_qp51", 64, 64, 1, 51, 3, "I", 8),
    ("i96x48", 96, 48, 2, 27, 4, "I", 8),
    ("i176x144", 176, 144, 2, 32, 5, "I", 8),
    ("i10_96x64", 96, 64, 2, 32, 21, "I", 10),
]


def _stream(fixtures_dir, name, w, h, n, qp, seed, gop, bd=8, **kw):
    return make_stream(fixtures_dir / f"torch_{name}.evc", w, h, n, qp, seed,
                       gop, bd=bd, **kw)


def _decode(stream, out, backend, out_bd=10):
    """Decode with one backend's app (the port's CLI for "torch",
    `xevd_tpu`'s for the others); returns the rc and the written bytes."""
    bd_args = ["--output-bit-depth", str(out_bd)] if out_bd else []
    if backend == "torch":
        from xevd_tpu_torch.app import main
        rc = main(["-i", str(stream), "-o", str(out), "-v", "0",
                   "--device", "cpu", *bd_args])
    else:
        from xevd_tpu.app import main
        use_port_native_library()
        rc = main(["-i", str(stream), "-o", str(out), "-v", "0",
                   "--backend", backend, *bd_args])
    return rc, (out.read_bytes() if out.exists() else b"")


def assert_backends_agree(fixtures_dir, tmp_path, name, w, h, n, qp, seed,
                          gop, bd, profile=0, tools=(), frames=None):
    """Decode one generated stream with the torch backend (the port's
    `Decoder`) and the numpy backend (`xevd_tpu`'s `Decoder`); all
    `frames` frames written (default n; an RA stream rounds n up to whole
    GOPs), the two outputs equal, and every frame equal to the JAX
    backend's (its stored decode, tests/torch_jax_reference.py).
    `profile` 1 with `tools` (tools/evc_enc.py Tools flags) makes a Main
    stream."""
    stream = _stream(fixtures_dir, name, w, h, n, qp, seed, gop, bd,
                     profile=profile, tools=tools)
    outs = {}
    with one_torch_thread():
        for backend in ("torch", "numpy"):
            rc, outs[backend] = _decode(stream, tmp_path / f"{backend}.yuv",
                                        backend)
            assert rc == 0, backend
    # 4:2:0, 2 bytes a sample
    assert len(outs["torch"]) == (frames or n) * w * h * 3
    assert_equals_jax(outs["torch"], stream.read_bytes(), w, h, name)
    assert outs["torch"] == outs["numpy"], f"{name}: torch != numpy"


@pytest.mark.parametrize("name,w,h,n,qp,seed,gop,bd", CASES)
def test_torch_equals_jax_and_numpy(fixtures_dir, tmp_path, name, w, h, n,
                                    qp, seed, gop, bd):
    assert_backends_agree(fixtures_dir, tmp_path, name, w, h, n, qp, seed,
                          gop, bd)


def test_eight_bit_output(fixtures_dir, tmp_path):
    """Default 8-bit output: the (v + 2) >> 2 path of the 10-bit tag
    (tests/test_golden.py test_eight_bit_output_quirk)."""
    stream = _stream(fixtures_dir, "i64", 64, 64, 1, 30, 1, "I")
    rc_t, got = _decode(stream, tmp_path / "t8.yuv", "torch", out_bd=0)
    rc_n, want = _decode(stream, tmp_path / "n8.yuv", "numpy", out_bd=0)
    assert rc_t == rc_n == 0
    assert len(got) == 64 * 64 * 3 // 2
    assert got == want


def test_dpb_planes_equal_jax(fixtures_dir):
    """The padded DPB pictures (the decoder's state), not only the output:
    the JAX backend's planes (under `xevd_tpu`'s `Decoder`), carried into
    the port with planes_from_numpy, equal the port's own (under its own
    `Decoder`), after an intra stream and after an RA stream (the last
    picture decoded there is a B picture)."""
    import xevd_tpu
    from xevd_tpu.ops.pipeline import JaxPixelBackend
    from xevd_tpu_torch import Decoder, TorchPixelBackend, info
    from xevd_tpu_torch.host import NAL_UNIT_LENGTH_BYTE
    from xevd_tpu_torch.ops.tables import planes_from_numpy

    use_port_native_library()
    for stream in (_stream(fixtures_dir, "i96x48", 96, 48, 2, 27, 4, "I"),
                   _stream(fixtures_dir, "dpb_ra10_96", 96, 64, 5, 32, 21,
                           "RA", 10)):
        data = stream.read_bytes()
        pics = {}
        for key, decoder, backend in (
                ("jax", xevd_tpu.Decoder, JaxPixelBackend()),
                ("torch", Decoder, TorchPixelBackend(device="cpu"))):
            dec = decoder(backend=backend)
            pos = 0
            while pos + NAL_UNIT_LENGTH_BYTE <= len(data):
                ln, _, _ = info(data[pos:pos + 6])
                dec.decode(data[pos + 4:pos + 4 + ln])
                pos += 4 + ln
            dec._drain_pipeline()
            pics[key] = dec.last_pic
        j, t = pics["jax"], pics["torch"]
        jy, ju, jv = planes_from_numpy(np.asarray(j.y), np.asarray(j.u),
                                       np.asarray(j.v), "cpu")
        for a, b in ((jy, t.y), (ju, t.u), (jv, t.v)):
            assert a.shape == b.shape
            assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name,w,h,n,qp,seed,gop,tools,missing", [
    # tuples of tests/test_main_profile.py CASES_AFFINE
    ("m_aff_p", 176, 144, 4, 30, 951, "IPPP",
     ("admvp", "hmvp", "affine", "eipd", "cm_init"), "affine"),
    ("m_ibc_i", 176, 144, 3, 30, 961, "I", ("ibc", "eipd", "cm_init"), "IBC"),
    ("m_ibc_addb", 176, 144, 5, 30, 973, "RA",
     ("ibc", "admvp", "hmvp", "amvr", "mmvd", "btt", "suco", "adcc", "iqt",
      "ats", "addb", "eipd", "cm_init"), "IBC"),
    # DMVR and BTT without EIPD, on short streams of their own
    ("dmvr_p", 64, 64, 2, 30, 971, "IPPP",
     ("dmvr", "admvp", "hmvp", "eipd", "cm_init"), "DMVR"),
    ("btt_no_eipd_i", 64, 64, 1, 30, 106, "I", ("btt", "cm_init"), "EIPD"),
])
def test_refuses_unported_main_tools(fixtures_dir, tmp_path, name, w, h, n,
                                     qp, seed, gop, tools, missing):
    """A Main stream with a tool that the JAX backend refuses too (affine,
    IBC, DMVR, BTT without EIPD) is refused at its SPS, before any frame,
    with a message that names the tool, also beside ADDB and SUCO, which
    the port decodes."""
    stream = _stream(fixtures_dir, f"main_{name}", w, h, n, qp, seed, gop,
                     profile=1, tools=tools)
    rc, out = _decode(stream, tmp_path / "m.yuv", "torch")
    assert rc != 0 and out == b""
    from xevd_tpu_torch import Decoder, TorchPixelBackend, info
    data = stream.read_bytes()
    ln, _, _ = info(data[:6])
    with pytest.raises(UnsupportedStream, match=missing):
        Decoder(backend=TorchPixelBackend(device="cpu")).decode(
            data[4:4 + ln])


_CUT_LOOSE = """
import importlib, pkgutil, sys
import xevd_tpu_torch
for m in pkgutil.walk_packages(xevd_tpu_torch.__path__, "xevd_tpu_torch."):
    importlib.import_module(m.name)
import xevd_tpu_torch.app, xevd_tpu_torch.profile, tests.torch_helpers
import xevd_tpu_torch.bench, xevd_tpu_torch.diff, xevd_tpu_torch.entry
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "xevd_tpu")]
assert not bad, bad
assert "xevd_tpu_torch.host.decoder" in sys.modules
assert {"xevd_tpu_torch.parallel.gop", "xevd_tpu_torch.native_build",
        "xevd_tpu_torch.bench", "xevd_tpu_torch.diff",
        "xevd_tpu_torch.entry"} <= set(sys.modules)
print(len([m for m in sys.modules if m.startswith("xevd_tpu_torch.")]))
"""


def test_import_leaves_jax_out():
    """In a fresh interpreter (this one has jax loaded by conftest), the
    port with every submodule, its CLI, profile tool, benchmark, diff tool
    and graft entry, the shared test helpers and chip_smoke.py (imported,
    not run) load neither JAX nor any module of `xevd_tpu`: the port runs
    on its own host copy."""
    r = subprocess.run([sys.executable, "-c", _CUT_LOOSE], cwd=REPO,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) > 40, r.stdout


def test_cuda_device_without_gpu_raises():
    import torch
    from xevd_tpu_torch import TorchPixelBackend
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        TorchPixelBackend(device="cuda")


def test_device_plane_reads_like_an_array():
    import torch
    from xevd_tpu_torch.plane import DevicePlane
    a = np.arange(48, dtype=np.int16).reshape(6, 8)
    p = DevicePlane(torch.from_numpy(a.copy()))
    assert p.shape == (6, 8)
    assert p[1:4, 2:5].shape == (3, 3)
    np.testing.assert_array_equal(np.asarray(p[1:4, 2:5]), a[1:4, 2:5])
    assert np.asarray(p, dtype=np.int32).dtype == np.int32


def _fake_frame(x, y, log2):
    """A one-CU intra frame syntax (64x64, coded luma and chroma)."""
    from types import SimpleNamespace
    a = np.array
    fs = SimpleNamespace(
        cu_x=a([x]), cu_y=a([y]), cu_log2w=a([log2]), cu_log2h=a([log2]),
        cu_pred_mode=a([0]), cu_ipm=a([0]), cu_qp=a([30]), cu_qp_u=a([30]),
        cu_qp_v=a([30]), cu_cbf=a([[1, 1, 1]]), cu_ats=np.zeros((1, 3), int),
        coef_y=np.zeros((64, 64), np.int16),
        coef_u=np.zeros((32, 32), np.int16),
        coef_v=np.zeros((32, 32), np.int16), w_pad=64, h_pad=64)
    job = SimpleNamespace(cu_nbr_up=a([0]), cu_nbr_left=a([0]),
                          cu_nbr_corner=a([0], np.uint8))
    return fs, job


@pytest.mark.parametrize("x,y,log2", [(32, 0, 6), (0, 48, 5), (0, 0, 7)])
def test_pack_rejects_blocks_outside_their_planes(x, y, log2):
    """The kernels read without clamping: the pack refuses a TU or CU that
    would reach outside its plane (or past the 64-point bases)."""
    from xevd_tpu_torch.ops import pack as PK
    fs, job = _fake_frame(x, y, log2)
    with pytest.raises(ValueError):
        PK.pack_itdq(fs, 8, True)
    with pytest.raises(ValueError):
        PK.pack_intra(fs, job)
    fs, job = _fake_frame(0, 0, 6)      # the same frame, in bounds
    assert PK.pack_itdq(fs, 8, True).shape == (3, 7)
    assert PK.pack_intra(fs, job).shape == (1, 8)
