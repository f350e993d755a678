"""xevd_tpu_torch -- the EVC decoder's device half in PyTorch, with
hand-written CUDA and Triton kernels for NVIDIA Hopper (H100).

The host half (bitstream, entropy decode, derive, DPB, `Decoder`) is the
JAX-free code of `xevd_tpu`, reused by import; this package provides the
pixel backend that plugs into it:

    from xevd_tpu_torch import Decoder, TorchPixelBackend
    dec = Decoder(backend=TorchPixelBackend(device="cuda"))

Nothing here imports JAX.
"""
from xevd_tpu import Decoder, info

from .ops.pipeline import TorchPixelBackend

__all__ = ["Decoder", "TorchPixelBackend", "info"]
