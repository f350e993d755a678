"""Device selection: explicit, never automatic."""
from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """Return the torch device for "cuda" or "cpu".

    "cuda" raises when no GPU is visible; there is no silent fallback to the
    CPU.  "cpu" runs every stage through its plain PyTorch version and is
    meant for tests and debugging."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return dev
