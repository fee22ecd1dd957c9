"""Masksembles layer helpers — the part of ``repro.core.masksembles`` that
the IVIM model uses: dense initialisation and the mask-to-example mapping of
training (contiguous groups) and inference (every example under every mask).
"""

from __future__ import annotations

import math

import torch

__all__ = ["dense_init", "mask_ids_for_batch", "repeat_for_samples"]


def dense_init(generator: torch.Generator, d_in: int, d_out: int
               ) -> dict[str, torch.Tensor]:
    """He-normal fp32 weights ``w [d_in, d_out]`` and zero bias ``b [d_out]``,
    on the generator's device."""
    dev = generator.device
    w = torch.randn(d_in, d_out, generator=generator, device=dev) \
        * math.sqrt(2.0 / d_in)
    return {"w": w, "b": torch.zeros(d_out, device=dev)}


def mask_ids_for_batch(batch: int, n_masks: int,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """Masksembles batch-group assignment: example ``j`` uses mask
    ``j * n // batch`` (contiguous groups, as in the reference impl)."""
    return torch.arange(batch, device=device) * n_masks // batch


def repeat_for_samples(x: torch.Tensor, n_masks: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inference-time expansion: every input under every mask ->
    ``(x_rep [n*B, ...], mask_ids [n*B])`` (mask-major rows)."""
    b = x.shape[0]
    x_rep = x.repeat((n_masks,) + (1,) * (x.ndim - 1))
    ids = torch.arange(n_masks, device=x.device).repeat_interleave(b)
    return x_rep, ids
