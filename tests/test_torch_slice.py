"""The PyTorch port's Baseline all-intra slice end to end, on the CPU.

Each stream is decoded by the torch backend (plain PyTorch versions), the
JAX backend and the numpy oracle backend; the written YUV must be equal
byte for byte.  Streams the port does not cover are refused."""
import subprocess
import sys

import numpy as np
import pytest

from xevd_tpu.syntax import UnsupportedStream

from .conftest import REPO, make_stream

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
    """Decode with one backend's app; returns the rc and the written bytes."""
    bd_args = ["--output-bit-depth", str(out_bd)] if out_bd else []
    if backend == "torch":
        from xevd_tpu_torch.app import main
        rc = main(["-i", str(stream), "-o", str(out), "-v", "0",
                   "--device", "cpu", *bd_args])
    else:
        from xevd_tpu.app import main
        rc = main(["-i", str(stream), "-o", str(out), "-v", "0",
                   "--backend", backend, *bd_args])
    return rc, (out.read_bytes() if out.exists() else b"")


@pytest.mark.parametrize("name,w,h,n,qp,seed,gop,bd", CASES)
def test_torch_equals_jax_and_numpy(fixtures_dir, tmp_path, name, w, h, n,
                                    qp, seed, gop, bd):
    stream = _stream(fixtures_dir, name, w, h, n, qp, seed, gop, bd)
    outs = {}
    for backend in ("torch", "jax", "numpy"):
        rc, outs[backend] = _decode(stream, tmp_path / f"{backend}.yuv",
                                    backend)
        assert rc == 0, backend
    assert len(outs["torch"]) == n * w * h * 3  # 4:2:0, 2 bytes a sample
    assert outs["torch"] == outs["jax"], f"{name}: torch != jax"
    assert outs["torch"] == outs["numpy"], f"{name}: torch != numpy"


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
    the JAX backend's planes, carried into the port with planes_from_numpy,
    equal the port's own."""
    from xevd_tpu import Decoder, NAL_UNIT_LENGTH_BYTE, info
    from xevd_tpu.ops.pipeline import JaxPixelBackend
    from xevd_tpu_torch import TorchPixelBackend
    from xevd_tpu_torch.ops.tables import planes_from_numpy

    data = _stream(fixtures_dir, "i96x48", 96, 48, 2, 27, 4, "I").read_bytes()
    pics = {}
    for key, backend in (("jax", JaxPixelBackend()),
                         ("torch", TorchPixelBackend(device="cpu"))):
        dec = Decoder(backend=backend)
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


def test_refuses_inter_stream(fixtures_dir, tmp_path):
    """IPPP: the P frame is refused; no frame is written past it."""
    stream = _stream(fixtures_dir, "p64", 64, 64, 4, 30, 6, "IPPP")
    rc, out = _decode(stream, tmp_path / "p.yuv", "torch")
    assert rc != 0
    assert len(out) <= 64 * 64 * 3     # at most the I frame before it
    from xevd_tpu import Decoder, NAL_UNIT_LENGTH_BYTE, info
    from xevd_tpu_torch import TorchPixelBackend
    dec = Decoder(backend=TorchPixelBackend(device="cpu"))
    data = stream.read_bytes()
    pos = 0
    with pytest.raises(UnsupportedStream, match="inter"):
        while pos + NAL_UNIT_LENGTH_BYTE <= len(data):
            ln, _, _ = info(data[pos:pos + 6])
            dec.decode(data[pos + 4:pos + 4 + ln])
            pos += 4 + ln
        dec._drain_pipeline()


def test_refuses_main_stream(fixtures_dir, tmp_path):
    stream = _stream(fixtures_dir, "m_off_i", 64, 64, 1, 30, 101, "I",
                     profile=1)
    rc, out = _decode(stream, tmp_path / "m.yuv", "torch")
    assert rc != 0 and out == b""
    from xevd_tpu import Decoder, info
    from xevd_tpu_torch import TorchPixelBackend
    data = stream.read_bytes()
    ln, _, _ = info(data[:6])
    with pytest.raises(UnsupportedStream, match="Main"):
        Decoder(backend=TorchPixelBackend(device="cpu")).decode(
            data[4:4 + ln])


def test_import_leaves_jax_out():
    """A fresh interpreter (this one has jax loaded by conftest)."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, xevd_tpu_torch, xevd_tpu_torch.app; "
         "bad = [m for m in sys.modules if m.split('.')[0] == 'jax']; "
         "assert not bad, bad"],
        cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


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
    assert PK.pack_itdq(fs, 8, True).shape == (3, 6)
    assert PK.pack_intra(fs, job).shape == (1, 8)
