"""Constant tables on the device, and JAX/numpy picture state into the port.

The decoder has no weights: these tables are its parameters, and the DPB
planes are its state.  Values come from `xevd_tpu.tables` (numpy, no JAX)."""
from __future__ import annotations

import numpy as np
import torch

from xevd_tpu import tables as T

from ..plane import DevicePlane

# Bordered working planes: 72 px top/left, 136 px right/bottom, the same
# geometry as the JAX package (xevd_tpu/ops/jax_intra.py BORDER / PAD_R), so
# every neighbour read of the intra scan stays inside the allocation.
BORDER = 72
PAD_R = 136

PAD_L = T.PIC_PAD_SIZE_L        # DPB picture padding, luma (144)
PAD_C = T.PIC_PAD_SIZE_C        # chroma (72)
MIN_TX_VAL = T.MIN_TX_VAL
MAX_TX_VAL = T.MAX_TX_VAL


def device_tables(device: torch.device) -> dict:
    """DCT-2 bases on `device`.

    tm64: int32 [64, 64], the 64-point basis; the n-point basis is
          tm64[::64 // n, :n] (xevd_tpu/tables.py TM2..TM32)."""
    return {"tm64": torch.from_numpy(T.TM[6].astype(np.int32)).to(device)}


def planes_from_numpy(y, u, v, device) -> tuple:
    """Wrap host int16 picture planes (e.g. from the JAX backend) as
    DevicePlanes on `device`; u/v may be None (4:0:0).  The planes are
    copied, so the caller's arrays are never aliased."""
    def one(p):
        if p is None:
            return None
        return DevicePlane(torch.from_numpy(
            np.array(p, dtype=np.int16)).to(device))
    return one(y), one(u), one(v)
