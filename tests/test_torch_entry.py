"""The port's graft entry (xevd_tpu_torch/entry.py) on the CPU: its step --
one 16x16 Baseline ITDQ bucket, recon and both luma deblock passes --
equals `__graft_entry__.entry()`'s under jax.jit on the same inputs in
JAX's layout, byte for byte (tolerance 0); its inputs are the JAX
entry's draws; and it refuses "cuda" without a card.  On the card,
test_torch_cuda.py holds entry("cuda") to entry("cpu")."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from xevd_tpu_torch.entry import H, W, entry


def _jax_layout(st_ver, st_hor):
    """The per-SCU maps as JAX's example takes them: a row of st_ver a
    sample row, a column of st_hor a sample column."""
    return (jnp.asarray(np.repeat(st_ver, 4, axis=0)),
            jnp.asarray(np.repeat(st_hor, 4, axis=1)))


def test_entry_inputs_are_the_jax_entrys_draws():
    _, jargs = GE.entry()
    _, args = entry("cpu")
    for j, t in zip(jargs[:4], args[:4]):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    for st in args[4:]:
        assert tuple(st.shape) == (H // 4, W // 4)
        assert set(np.unique(st.numpy())) == {0, 4}


def test_entry_step_equals_jax_graft_step():
    jfn, jargs = GE.entry()
    fn, args = entry("cpu")
    want = np.asarray(jax.jit(jfn)(*jargs[:4], *_jax_layout(
        args[4].numpy(), args[5].numpy())))
    got = fn(*args)
    assert got.dtype == torch.int16 and tuple(got.shape) == (H, W)
    assert want.dtype == np.int16
    np.testing.assert_array_equal(got.numpy(), want)
    # the deblock is not vacuous: without the maps the picture differs,
    # and equals JAX's without them too
    zero = torch.zeros_like(args[4])
    flat = fn(*args[:4], zero, zero).numpy()
    assert (flat != got.numpy()).sum() > 100
    np.testing.assert_array_equal(flat, np.asarray(jax.jit(jfn)(
        *jargs[:4], *_jax_layout(zero.numpy(), zero.numpy()))))


def test_entry_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        entry("cuda")
