"""The store of the JAX package's answers for the port's gate streams
(tests/torch_jax_reference.py): a stored answer is used with no JAX
decode, a stored MD5 with one bit flipped fails the comparison and names
its frame, and a stream the store does not hold is decoded live (here a
stub) with a warning that names the case.  `slow`: every entry, remade
from its spec by the JAX package, equals the file."""
import hashlib
import json

import pytest

from xevd_tpu_torch.bench import yuv_md5s

from . import torch_jax_reference as R
from .test_torch_slice import _decode, _stream


@pytest.mark.parametrize("mode", ["stored", "flipped", "missing"])
def test_store_lookup(fixtures_dir, tmp_path, monkeypatch, mode):
    stream = _stream(fixtures_dir, "i96x48", 96, 48, 2, 27, 4, "I")
    data = stream.read_bytes()
    rc, yuv = _decode(stream, tmp_path / "t.yuv", "torch")
    assert rc == 0
    store = dict(R._store())
    key = (hashlib.sha256(data).hexdigest(), R.OUT_BD)
    assert key in store, "i96x48 is not stored under this tree's code " \
        "digest: run python -m tests.torch_jax_reference --update"
    live = []

    def decode_jax(d, w, h):
        live.append(d)
        assert mode == "missing", "a stored answer was decoded live"
        return yuv_md5s(yuv, w, h)

    monkeypatch.setattr(R, "decode_jax", decode_jax)
    monkeypatch.setattr(R, "_store", lambda: store)
    if mode == "stored":
        R.assert_equals_jax(yuv, data, 96, 48, "i96x48")
        assert live == []
    elif mode == "flipped":
        md5s = list(store[key])
        md5s[1] = f"{int(md5s[1], 16) ^ 1:032x}"
        store[key] = md5s
        with pytest.raises(AssertionError, match=r"i96x48: frame 1 differs"):
            R.assert_equals_jax(yuv, data, 96, 48, "i96x48")
        assert live == []
    else:
        del store[key]
        with pytest.warns(R.StoreMiss, match="i96x48"):
            R.assert_equals_jax(yuv, data, 96, 48, "i96x48")
        assert live == [data]


@pytest.mark.slow
def test_store_equals_a_fresh_derivation():
    """Every entry's key and answer remade by the JAX package from its
    spec (one process an entry), under this tree's code digest, equal
    the committed file."""
    doc = json.loads(R.STORE.read_text())
    assert R.derive_all(doc) == doc
