"""Model facade: one object per architecture config, uniform API (the
port's twin of ``repro.models.model``).

    model = build_model(get_config("qwen2-1.5b", mask_samples=4))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    loss, metrics = model.loss(params, batch)       # training graph
    logits, aux = model.forward(params, {"tokens": tokens})  # or embeds
    logits, cache = model.prefill(params, {"tokens": tokens}, max_seq=M)
    logits, cache = model.decode_step(params, cache, tok, pos)

``param_specs()`` and ``input_specs(shape)`` give ``meta``-device tensors,
the port's stand-in for ``jax.ShapeDtypeStruct``: shapes and dtypes,
nothing allocated.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import tree as tree_lib
from repro_torch.models import layers, transformer

Params = dict[str, Any]

__all__ = ["Model", "build_model", "cross_entropy", "MOE_AUX_WEIGHT"]

MOE_AUX_WEIGHT = 0.01


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Token-mean cross entropy, the reference's arithmetic: logits in
    fp32, a max-subtracted logsumexp (the max held constant, as
    ``stop_gradient`` holds it), minus the label's logit."""
    lf = logits.float()
    m = lf.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lf - m).sum(-1)) + m[..., 0]
    gold = torch.take_along_dim(lf, labels[..., None].long(), -1)[..., 0]
    return (lse - gold).mean()


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # ---- construction ------------------------------------------------------
    def init(self, generator: torch.Generator,
             device: torch.device | str | None = None) -> Params:
        return transformer.init(self.cfg, generator, device=device)

    def param_specs(self) -> Params:
        """The parameter tree as ``meta``-device tensors (shapes and
        dtypes; nothing allocated): ``init`` traced under a fake-tensor
        mode, as ``jax.eval_shape`` traces it."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode(allow_non_fake_inputs=True):
            fake = transformer.init(self.cfg, torch.Generator(),
                                    device="cpu")
        return tree_lib.tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
            fake)

    # ---- training ----------------------------------------------------------
    def forward(self, params: Params, batch: Params,
                mask_ids: torch.Tensor | None = None,
                device: torch.device | str | None = None):
        """Inference form (no gradients; ``transformer.forward``)."""
        return transformer.forward(self.cfg, params, batch,
                                   mask_ids=mask_ids, device=device)

    def loss(self, params: Params, batch: Params
             ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """The training loss on the device ``params`` live on: (ce +
        ``MOE_AUX_WEIGHT`` * aux, {"ce", "moe_aux"}), through
        ``transformer.forward_train``."""
        logits, aux = transformer.forward_train(self.cfg, params, batch)
        # DTensor's pick of the label's logit along a vocab-sharded dim
        # leaves a mask it cannot reduce: gather the vocab dim first
        logits = layers.constrain(logits, ("batch", None, None))
        ce = cross_entropy(logits, batch["labels"].to(logits.device))
        total = ce + MOE_AUX_WEIGHT * aux
        return total, {"ce": ce, "moe_aux": aux}

    # ---- serving -----------------------------------------------------------
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

    # ---- dry-run inputs ----------------------------------------------------
    def input_specs(self, shape: InputShape) -> Params:
        """``meta``-device stand-ins for one cell's inputs.

        train   -> kwargs of train_step(batch=...)
        prefill -> kwargs of prefill(batch=...)
        decode  -> kwargs of decode_step(tokens=..., pos=...) (the caches
                   come from :meth:`cache_specs`).
        """
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        i32, d = torch.int32, cfg.d_model

        def spec(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        if shape.kind == "train":
            batch: Params = {"labels": spec((b, s), i32)}
            if cfg.embeds_input and cfg.family == "audio":
                batch["embeds"] = spec((b, s, d), cfg.dtype)
            else:
                batch["tokens"] = spec((b, s), i32)
            return {"batch": batch}
        if shape.kind == "prefill":
            batch = {}
            if cfg.embeds_input:
                # modality frontend stub: precomputed frame/patch embeddings
                batch["embeds"] = spec((b, s, d), cfg.dtype)
                if cfg.m_rope_sections:
                    batch["positions"] = spec((3, b, s), i32)
            else:
                batch["tokens"] = spec((b, s), i32)
            return {"batch": batch}
        if shape.kind == "decode":
            if not cfg.has_decode:
                raise ValueError(f"{cfg.arch_id} is encoder-only: no decode")
            return {"tokens": spec((b, 1), i32), "pos": spec((), i32)}
        raise ValueError(shape.kind)


def build_model(cfg: ModelConfig) -> Model:
    """The model of ``cfg``: every family of the registry (dense, MoE,
    hybrid, audio encoder, vision-language with M-RoPE, xLSTM)."""
    return Model(cfg)
