"""DevicePlane: a decoded picture plane that stays on the device.

The host half of the decoder (DPB, output writer, picture-signature check)
reads planes with `np.asarray(plane[rows, cols])` and `plane.shape`.  A bare
CUDA tensor refuses `np.asarray`; this holder answers both by copying the
requested view to the host only when it is read."""
from __future__ import annotations

import torch


class DevicePlane:
    __slots__ = ("t",)

    def __init__(self, t: torch.Tensor):
        if t.dim() != 2 or t.dtype != torch.int16:
            raise ValueError(f"DevicePlane wants a 2-D int16 tensor, "
                             f"got {tuple(t.shape)} {t.dtype}")
        self.t = t

    @property
    def shape(self):
        return tuple(self.t.shape)

    def __getitem__(self, idx):
        return DevicePlane(self.t[idx])

    def __array__(self, dtype=None, copy=None):
        a = self.t.cpu().numpy()
        return a if dtype is None else a.astype(dtype)
