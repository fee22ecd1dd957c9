"""Token data pipeline — stateless, seeded, shard-local (the port's twin of
``repro.data.pipeline``).

Batch ``i`` is a pure function of ``(config, i)``: a restarted run gets
bit-identical batches without replaying the stream, each data-parallel host
builds only its own rows (:func:`host_slice`), and there is no state to
checkpoint. The token stream is the reference's numpy generator, step for
step, so the port's batches are bit-equal to the reference's: a noisy
Markov chain over the vocabulary (structured enough for the loss to fall).
The audio family gets frame embeddings from the same seeded projection of
the stream (the modality frontend is a stub).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import device as device_lib

__all__ = ["LMDataConfig", "lm_batch", "batch_specs", "host_slice"]


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    family: str = "dense"       # audio -> embeds instead of tokens
    d_model: int = 0            # for the embeds stub
    dtype: Any = torch.float32


def _tokens_for_step(cfg: LMDataConfig, step: int) -> np.ndarray:
    """Noisy Markov stream: next = (a*cur + b + noise) mod V. The (a, b)
    rule is fixed per *seed* (so the mapping is learnable across steps);
    starting states and noise are fresh per step."""
    rule = np.random.default_rng((cfg.seed, 0xA11CE))
    a = int(rule.integers(2, 7))
    off = int(rule.integers(1, cfg.vocab_size))
    rng = np.random.default_rng((cfg.seed, step))
    b, s = cfg.global_batch, cfg.seq_len
    x = np.empty((b, s + 1), np.int64)
    x[:, 0] = rng.integers(0, cfg.vocab_size, size=b)
    noise = rng.integers(0, 2, size=(b, s))
    for t in range(s):
        x[:, t + 1] = (a * x[:, t] + off + noise[:, t]) % cfg.vocab_size
    return x


def lm_batch(cfg: LMDataConfig, step: int,
             device: torch.device | str | None = None
             ) -> dict[str, torch.Tensor]:
    """Global batch for ``step`` on ``device`` (None -> the card):
    {tokens [B, S] int32 | embeds [B, S, d_model] in ``cfg.dtype``, labels
    [B, S] int32}."""
    dev = device_lib.resolve(device)
    x = _tokens_for_step(cfg, step)
    tokens, labels = x[:, :-1], x[:, 1:]
    labels = torch.from_numpy(labels.astype(np.int32)).to(dev)
    if cfg.family == "audio":
        rng = np.random.default_rng((cfg.seed, 0xBEEF))
        proj = rng.standard_normal((cfg.vocab_size, cfg.d_model)) * 0.1
        embeds = torch.from_numpy(proj[tokens].astype(np.float32))
        return {"embeds": embeds.to(device=dev, dtype=cfg.dtype),
                "labels": labels}
    return {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(dev),
            "labels": labels}


def host_slice(batch: dict[str, torch.Tensor], host_id: int,
               n_hosts: int) -> dict[str, torch.Tensor]:
    """The shard-local view: rows owned by ``host_id``."""
    def sl(x):
        per = x.shape[0] // n_hosts
        return x[host_id * per:(host_id + 1) * per]

    return {k: sl(v) for k, v in batch.items()}


def batch_specs(cfg: LMDataConfig) -> dict[str, torch.Tensor]:
    """The batch's leaves as ``meta``-device tensors (shape and dtype,
    nothing allocated)."""
    b, s = cfg.global_batch, cfg.seq_len
    meta = torch.device("meta")
    out = {"labels": torch.empty((b, s), dtype=torch.int32, device=meta)}
    if cfg.family == "audio":
        out["embeds"] = torch.empty((b, s, cfg.d_model), dtype=cfg.dtype,
                                    device=meta)
    else:
        out["tokens"] = torch.empty((b, s), dtype=torch.int32, device=meta)
    return out
