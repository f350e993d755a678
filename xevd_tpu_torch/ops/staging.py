"""Reused host buffers for the host->device copies: the port of the JAX
backend's double-buffered payload (`JaxPixelBackend._payload_bufs` /
`_payload_flip`, xevd_tpu/ops/pipeline.py:399-412, 493-499, 534-537).

A `HostStaging` is a ring of `depth` slots (2 by default, as JAX's).  A
slot holds the int32 payload buffer and the int16 coefficient buffer that
one frame is packed into (ops/pack.py `pack_frame`), or one GOP step is
copied into (`stage_batch`), and on a CUDA device the event recorded on
the stream right after that slot's copies were issued (ops/pack.py
`upload`, `upload_batch`).  For a CUDA device the buffers are pinned, so
a copy with `non_blocking=True` returns at once and runs behind the
host; for the CPU they are ordinary tensors, and the upload clones
them.

`acquire` hands out the next slot, after waiting on its event: no pack
writes into memory that a copy still in flight reads.  The event is the
only guard.  PyTorch's pinned-memory allocator keeps a freed block from
being handed out again before its copies end, but it does not stop the
owner of a tensor from rewriting it.  Nor does the ring's depth decide:
the decoder packs frame n while slice n + 1 is entropy-decoded, or when
an output is read (host/decoder.py:707-715, `_LazyPlane._resolve`), and
the CLI holds frames in its lookahead, so a slot may come round again one
frame or several after its copy was issued.

A slot too small for what is packed into it grows to the need plus a
quarter (xevd_tpu/ops/pipeline.py:534-537) and keeps its buffers for the
ring's life."""
from __future__ import annotations

import time

import numpy as np
import torch


class HostSlot:
    """One slot of a `HostStaging` ring: `payload` int32 and `coefs` int16
    host tensors (pinned for a CUDA device), their numpy views
    `payload_np` and `coefs_np`, and `event`, the CUDA event the upload
    records after issuing the slot's copies (None for the CPU)."""

    def __init__(self, device: torch.device):
        self.pinned = device.type == "cuda"
        self.event = torch.cuda.Event() if self.pinned else None
        self.payload = self.coefs = None
        self.payload_np = self.coefs_np = None
        self.reserve(1, 1)

    def _buffer(self, n: int, dtype: torch.dtype) -> torch.Tensor:
        return torch.empty(n + (n >> 2), dtype=dtype, pin_memory=self.pinned)

    def reserve(self, payload_words: int = 0, coef_count: int = 0):
        """Grow a buffer that holds fewer than the words or coefficients
        asked for to the need plus a quarter.  Call only while no copy of
        this slot is in flight (after `HostStaging.acquire`)."""
        if self.payload is None or self.payload.numel() < payload_words:
            self.payload = self._buffer(payload_words, torch.int32)
            self.payload_np = self.payload.numpy()
        if self.coefs is None or self.coefs.numel() < coef_count:
            self.coefs = self._buffer(coef_count, torch.int16)
            self.coefs_np = self.coefs.numpy()

    def keep_payload(self, payload: np.ndarray) -> np.ndarray:
        """A payload that outgrew this slot (the packer's fresh array),
        copied into the head of the payload buffer once it has grown."""
        self.reserve(payload_words=payload.size)
        out = self.payload_np[:payload.size]
        out[...] = payload
        return out

    def sources(self, n_words: int, n_coefs: int):
        """The host tensors an upload copies: the heads of the buffers."""
        return self.payload[:n_words], self.coefs[:n_coefs]


class HostStaging:
    """A ring of `depth` `HostSlot`s for `device`.  `waits` counts the
    acquires that found their slot's copies still in flight, and
    `wait_seconds` adds up the host's time waiting for them."""

    def __init__(self, device, depth: int = 2):
        if depth < 1:
            raise ValueError(f"HostStaging: depth {depth} < 1")
        self.device = torch.device(device)
        self.slots = [HostSlot(self.device) for _ in range(depth)]
        self.next = 0
        self.waits = 0
        self.wait_seconds = 0.0

    def acquire(self, payload_words: int = 0, coef_count: int = 0
                ) -> HostSlot:
        """The next slot of the ring, once the copies it last fed have
        ended (its event), with room for `payload_words` and
        `coef_count`."""
        slot = self.slots[self.next]
        self.next = (self.next + 1) % len(self.slots)
        if slot.event is not None and not slot.event.query():
            t0 = time.perf_counter()
            slot.event.synchronize()
            self.wait_seconds += time.perf_counter() - t0
            self.waits += 1
        slot.reserve(payload_words, coef_count)
        return slot
