"""Unsupervised physics-loss training of (u)IVIM-NET — paper §IV.

"each network is responsible for estimating a specific parameter that can be
utilized to reconstruct inputs. The loss is calculated as the mean-square
error (MSE) between the input and the reconstructed input derived using
equation (1)."

No labels are consumed: the model learns to invert Eq. (1). Masks stay
active during training (Masksembles = "enhanced dropout" with fixed drops)
and BN runs on batch statistics, updating its running buffers. The
optimizer is the reference's hand-written Adam (not ``torch.optim.Adam``:
its eps is added to ``sqrt(v)`` without bias correction and its weight decay
is decoupled), updating the module's parameters in place. The masks are
buffers, so they get no gradient and no update — the reference zeroes their
gradients instead, which leaves them unchanged at its default weight decay
of 0.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import device as device_lib
from repro_torch.ivim import data as data_lib
from repro_torch.ivim import model as model_lib

__all__ = ["TrainConfig", "loss_fn", "make_train_step", "train"]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 500
    batch_size: int = 128
    lr: float = 1e-3
    weight_decay: float = 0.0
    seed: int = 0


def loss_fn(model: model_lib.IvimNet, x: torch.Tensor) -> torch.Tensor:
    """MSE(x, reconstruct(model(x))) in the training form: masks active,
    BN on batch statistics (the module's running buffers are updated)."""
    pred = model._forward(x, None, train=True)
    recon = model_lib.reconstruct(model.cfg, pred)
    return ((recon - x) ** 2).mean()


def make_train_step(cfg: model_lib.IvimConfig, tcfg: TrainConfig
                    ) -> tuple[Callable, Callable]:
    """``(step, init_opt)``: ``init_opt(model)`` makes the Adam state
    ``{"mu", "nu": {name: zeros}, "count": 0}`` over the module's
    parameters; ``step(model, opt, x)`` takes one Adam step on batch ``x``
    in place and returns the loss (a 0-d tensor, before the update)."""

    def init_opt(model: model_lib.IvimNet) -> dict:
        params = dict(model.named_parameters())
        return {"mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()},
                "count": 0}

    def step(model: model_lib.IvimNet, opt: dict,
             x: torch.Tensor) -> torch.Tensor:
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss = loss_fn(model, x)
        loss.backward()
        opt["count"] += 1
        c = torch.tensor(float(opt["count"]), dtype=torch.float32)
        lr_t = float(tcfg.lr * torch.sqrt(1 - _B2 ** c) / (1 - _B1 ** c))
        with torch.no_grad():
            for k, p in params.items():
                g = p.grad
                m = opt["mu"][k].mul_(_B1).add_((1 - _B1) * g)
                v = opt["nu"][k].mul_(_B2).add_((1 - _B2) * g * g)
                p.sub_(lr_t * (m / (v.sqrt() + _EPS)
                               + tcfg.weight_decay * p))
        return loss.detach()

    return step, init_opt


def train(cfg: model_lib.IvimConfig, tcfg: TrainConfig,
          dataset: dict[str, torch.Tensor] | None = None,
          log_every: int = 0,
          device: torch.device | str | None = None
          ) -> tuple[model_lib.IvimNet, list[float]]:
    """A full training run on ``device`` (None -> the card): the model is
    ``ivim.model.init`` from ``torch.Generator().manual_seed(seed)``, the
    data ``ivim.data.make_dataset`` at the config's protocol and seed
    unless given. Returns ``(model, loss history)``; the model holds the
    trained parameters and BN running statistics."""
    dev = device_lib.resolve(device)
    if dataset is None:
        dataset = data_lib.make_dataset(data_lib.SyntheticConfig(
            b_values=cfg.b_values, seed=tcfg.seed), device=dev)
    batcher = data_lib.Batcher(dataset, tcfg.batch_size, seed=tcfg.seed)
    model = model_lib.init(cfg, torch.Generator().manual_seed(tcfg.seed),
                           device=dev)
    model.train()
    step, init_opt = make_train_step(cfg, tcfg)
    opt = init_opt(model)
    losses = []
    for i in range(tcfg.steps):
        losses.append(step(model, opt, batcher.batch(i)))
        if log_every and i % log_every == 0:
            print(f"step {i:5d}  loss {float(losses[-1]):.6f}")
    history = [float(v) for v in torch.stack(losses).cpu()] if losses else []
    return model, history
