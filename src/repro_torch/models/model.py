"""Model facade: one object per architecture config, the inference half of
``repro.models.model`` (training — the loss — is not ported yet).

    model = build_model(get_config("qwen2-1.5b", mask_samples=4))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    logits, aux = model.forward(params, {"tokens": tokens})  # or embeds
    logits, cache = model.prefill(params, {"tokens": tokens}, max_seq=M)
    logits, cache = model.decode_step(params, cache, tok, pos)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

Params = dict[str, Any]

__all__ = ["Model", "build_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: torch.Generator,
             device: torch.device | str | None = None) -> Params:
        return transformer.init(self.cfg, generator, device=device)

    def forward(self, params: Params, batch: Params,
                mask_ids: torch.Tensor | None = None,
                device: torch.device | str | None = None):
        return transformer.forward(self.cfg, params, batch,
                                   mask_ids=mask_ids, device=device)

    def prefill(self, params: Params, batch: Params,
                max_seq: int | None = None):
        return transformer.prefill(self.cfg, params, batch, max_seq=max_seq)

    def decode_step(self, params: Params, caches, tokens: torch.Tensor,
                    pos):
        return transformer.decode_step(self.cfg, params, caches, tokens, pos)

    def init_cache(self, batch: int, max_seq: int,
                   device: torch.device | str | None = None):
        return transformer.init_cache(self.cfg, batch, max_seq,
                                      device=device)

    def cache_specs(self, batch: int, max_seq: int):
        return transformer.cache_specs(self.cfg, batch, max_seq)


def build_model(cfg: ModelConfig) -> Model:
    """The model of ``cfg``: every family of the registry (dense, MoE,
    hybrid, audio encoder, vision-language with M-RoPE, xLSTM)."""
    return Model(cfg)
