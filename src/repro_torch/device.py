"""Device resolution for the port's entry points.

The counterpart of the reference's kernel-backend probe, without a probe:
there is no tier to pick. ``device=None`` means the card; the CPU runs only
when a caller names it (the tests do, to run the plain PyTorch versions).
"""

from __future__ import annotations

import torch

__all__ = ["resolve"]


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is absent. An explicit device
    is returned as a ``torch.device`` (a CUDA one also needs a card, and
    gets the current card's index, so it compares equal to a tensor's)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the card unless the "
                "caller passes device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
