"""xevd_tpu_torch -- the EVC decoder's device half in PyTorch, with
hand-written CUDA and Triton kernels for NVIDIA Hopper (H100).

The host half (bitstream, entropy decode, derive, DPB, `Decoder`) is
`xevd_tpu_torch.host`, the package's own copy of the JAX-free modules of
`xevd_tpu`; the pixel backend plugs into its `Decoder`:

    from xevd_tpu_torch import Decoder, TorchPixelBackend
    dec = Decoder(backend=TorchPixelBackend(device="cuda"))

Nothing here imports JAX or `xevd_tpu`.
"""
from .host import Decoder, MalformedBitstream, info
from .host.syntax import UnsupportedStream

from .ops.pipeline import TorchPixelBackend

__all__ = ["Decoder", "MalformedBitstream", "TorchPixelBackend",
           "UnsupportedStream", "info"]
