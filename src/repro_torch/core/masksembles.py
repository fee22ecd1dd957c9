"""Masked (Masksembles) layers — the training-time form of the paper's
BayesNN (the port's twin of ``repro.core.masksembles``).

Parameters are plain dicts of tensors; masks ride along as constant
tensors. Two execution forms exist:

* **training form** (this module): the batch is split into ``n_masks``
  groups and group ``i`` is multiplied by ``masks[i]`` after the activation
  — the Masksembles procedure (an "enhanced dropout" with fixed drops);
* **serving form** (:mod:`repro_torch.core.packing` +
  :mod:`repro_torch.core.scheduler`): masks are folded into packed dense
  weights offline (mask-zero skipping) and the ``n`` samples are scheduled
  batch-level; the same numbers, another traffic profile.

Initialisers draw from an explicit ``torch.Generator`` on its device;
:func:`params_from_jax` carries a reference parameter tree across.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import masks as masks_lib

Params = dict[str, Any]

__all__ = ["dense_init", "dense_apply", "masked_dense_init",
           "masked_dense_apply", "masked_ffn_init", "masked_ffn_apply",
           "mask_ids_for_batch", "repeat_for_samples", "params_from_jax"]


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32
               ) -> dict[str, torch.Tensor]:
    """He-normal weights ``w [d_in, d_out]`` (drawn in fp32) and zero bias
    ``b [d_out]`` in ``dtype``, on the generator's device."""
    dev = generator.device
    w = torch.randn(d_in, d_out, generator=generator, device=dev) \
        * math.sqrt(2.0 / d_in)
    return {"w": w.to(dtype), "b": torch.zeros(d_out, device=dev,
                                               dtype=dtype)}


def dense_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def masked_dense_init(generator: torch.Generator, d_in: int, d_out: int,
                      spec: masks_lib.MaskSpec,
                      dtype: torch.dtype = torch.float32) -> Params:
    """Dense layer whose *output* units are covered by Masksembles masks
    (``masks [n_masks, d_out]``, 0/1 in ``dtype``)."""
    if spec.width != d_out:
        raise ValueError(f"mask width {spec.width} != d_out {d_out}")
    p = dense_init(generator, d_in, d_out, dtype)
    p["masks"] = torch.from_numpy(
        masks_lib.generate_masks(spec).astype(np.float32)).to(
            generator.device, dtype)
    return p


def mask_ids_for_batch(batch: int, n_masks: int,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """Masksembles batch-group assignment: example ``j`` uses mask
    ``j * n // batch`` (contiguous groups, as in the reference impl)."""
    return torch.arange(batch, device=device) * n_masks // batch


def masked_dense_apply(params: Params, x: torch.Tensor,
                       mask_ids: torch.Tensor,
                       activation: Callable[[torch.Tensor], torch.Tensor]
                       | None = torch.relu) -> torch.Tensor:
    """y = act(x @ w + b) * masks[mask_ids].

    For zero-preserving activations (ReLU/GELU/SiLU: f(0)=0) this equals
    masking before the activation, which is what packing exploits."""
    y = dense_apply(params, x)
    if activation is not None:
        y = activation(y)
    return y * params["masks"][mask_ids]


def masked_ffn_init(generator: torch.Generator, d_in: int, d_hidden: int,
                    d_out: int, spec: masks_lib.MaskSpec,
                    dtype: torch.dtype = torch.float32) -> Params:
    """Two-layer FC block with a masked hidden dimension — the repeating
    unit of uIVIM-NET (linear → BN(folded) → ReLU → mask → linear). fc1 is
    drawn before fc2 from the one generator."""
    fc1 = masked_dense_init(generator, d_in, d_hidden, spec, dtype)
    return {"fc1": fc1, "fc2": dense_init(generator, d_hidden, d_out, dtype)}


def masked_ffn_apply(params: Params, x: torch.Tensor,
                     mask_ids: torch.Tensor) -> torch.Tensor:
    h = masked_dense_apply(params["fc1"], x, mask_ids)
    return dense_apply(params["fc2"], h)


def repeat_for_samples(x: torch.Tensor, n_masks: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inference-time expansion: every input under every mask ->
    ``(x_rep [n*B, ...], mask_ids [n*B])`` (mask-major rows) — the naive
    (sampling-level, unpacked) evaluation path, the baseline of the
    scheduler's and packing's savings."""
    b = x.shape[0]
    x_rep = x.repeat((n_masks,) + (1,) * (x.ndim - 1))
    ids = torch.arange(n_masks, device=x.device).repeat_interleave(b)
    return x_rep, ids


def params_from_jax(params: Params,
                    device: torch.device | str | None = None) -> Params:
    """A parameter tree of this module holding a reference tree's values
    (numpy arrays or anything ``np.asarray`` takes, nested dicts), as fp32
    tensors on ``device`` (None -> the card)."""
    dev = device_lib.resolve(device)
    if isinstance(params, dict):
        return {k: params_from_jax(v, dev) for k, v in params.items()}
    return torch.tensor(np.asarray(params, np.float32), device=dev)
