"""Training loop: the step function and the fault-tolerant ``Trainer``
(the port's twin of ``repro.train.trainer``).

    state, metrics = train_step(state, batch)

with state = {params, opt, ef} (``ef``: the error-feedback residual when
gradient compression is on). The step:

  * gradients by ``torch.autograd.grad`` of ``Model.loss`` (the training
    graph: the reference's attention branches, the ``rglru_scan`` kernel
    and its backward, ``cfg.remat`` around each repeat);
  * gradient accumulation over ``grad_accum`` equal microbatches, summed
    in fp32 trees (each microbatch takes the Masksembles assignment of its
    own rows, as in the reference; its metrics report ``moe_aux`` 0);
  * int8 error-feedback compression of the gradient (``compress_grads``);
  * the optimizer's in-place update (masks never updated).

The ``Trainer`` owns seeded init on its device, checkpoint rotation and
resume (``distributed.checkpoint``), stateless data (``data.lm_batch``:
a resumed run sees the batches an uninterrupted one would) and the
straggler monitor's escalation hook.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch import device as device_lib
from repro_torch.core import tree as tree_lib
from repro_torch.data import pipeline as data_lib
from repro_torch.distributed import checkpoint as ckpt_lib
from repro_torch.distributed import compression, straggler
from repro_torch.models.model import Model
from repro_torch.optim import Optimizer

Params = Any

__all__ = ["TrainConfig", "train_state_init", "train_state_specs",
           "make_train_step", "Trainer"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    grad_accum: int = 1
    compress_grads: bool = False     # int8 error feedback
    checkpoint_dir: str = ""
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    seed: int = 0


def train_state_init(model: Model, optimizer: Optimizer,
                     generator: torch.Generator, compress: bool = False,
                     device: torch.device | str | None = None) -> Params:
    """Parameters drawn from ``generator`` on ``device`` (None -> the
    card), the optimizer's state beside them, and a zero ``ef`` residual
    with ``compress``."""
    params = model.init(generator, device=device)
    state: Params = {"params": params, "opt": optimizer.init(params)}
    if compress:
        state["ef"] = compression.ef_init(params)
    return state


def train_state_specs(model: Model, optimizer: Optimizer,
                      compress: bool = False) -> Params:
    """The full train state as ``meta``-device tensors (nothing
    allocated)."""
    params = model.param_specs()
    state: Params = {"params": params, "opt": optimizer.init(params)}
    if compress:
        state["ef"] = compression.ef_init(params)
    return state


def make_train_step(model: Model, optimizer: Optimizer,
                    tcfg: TrainConfig) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``. The
    state's parameters and moments are updated in place (the returned
    state holds the same tensors, and a new ``ef``); metrics are 0-d
    tensors {"ce", "moe_aux", "loss", "gnorm"} on the state's device."""

    def value_and_grad(params, batch):
        leaves = tree_lib.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def compute_grads(params, batch):
        if tcfg.grad_accum <= 1:
            loss, metrics, grads = value_and_grad(params, batch)
            return loss, metrics, tree_lib.unflatten(params, grads)
        k = tcfg.grad_accum
        b = tree_lib.leaves(batch)[0].shape[0]
        if b % k != 0:
            raise ValueError(
                f"grad_accum {k} does not divide the global batch {b} — "
                f"microbatches must be equal-sized")
        per = b // k
        acc = loss_sum = None
        for i in range(k):
            mb = {name: x[i * per:(i + 1) * per] for name, x in batch.items()}
            loss, _, grads = value_and_grad(params, mb)
            if acc is None:
                acc = [g.float() for g in grads]
                loss_sum = loss
            else:
                for a, g in zip(acc, grads):
                    a.add_(g.float())
                loss_sum = loss_sum + loss
            del grads
        inv = 1.0 / k
        grads = [a * inv for a in acc]
        loss = loss_sum * inv
        return loss, {"ce": loss, "moe_aux": torch.zeros_like(loss)}, \
            tree_lib.unflatten(params, grads)

    def train_step(state: Params, batch: Params) -> tuple[Params, Params]:
        params = state["params"]
        loss, metrics, grads = compute_grads(params, batch)
        new_ef = None
        if "ef" in state:
            grads, new_ef = compression.ef_update(grads, state["ef"])
        params, opt = optimizer.update(grads, state["opt"], params)
        new_state = {"params": params, "opt": opt}
        if new_ef is not None:
            new_state["ef"] = new_ef
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["gnorm"] = opt["gnorm"]
        return new_state, metrics

    return train_step


@dataclasses.dataclass
class Trainer:
    """Fault-tolerant loop on ``device`` (None -> the card): seeded init,
    seeded data, atomic checkpoints, auto-resume, straggler monitoring."""
    model: Model
    optimizer: Optimizer
    tcfg: TrainConfig
    data_cfg: data_lib.LMDataConfig
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = device_lib.resolve(self.device)
        self.step_fn = make_train_step(self.model, self.optimizer, self.tcfg)
        self.monitor = straggler.StragglerMonitor()
        self.ckpt = (ckpt_lib.CheckpointManager(self.tcfg.checkpoint_dir,
                                                self.tcfg.keep_checkpoints)
                     if self.tcfg.checkpoint_dir else None)

    def init_or_restore(self) -> tuple[int, Params]:
        """(first step, state): the latest checkpoint's, or a fresh state
        from ``tcfg.seed`` at step 0."""
        gen = torch.Generator(self.device).manual_seed(self.tcfg.seed)
        state = train_state_init(self.model, self.optimizer, gen,
                                 self.tcfg.compress_grads, self.device)
        if self.ckpt:
            restored = self.ckpt.restore_latest(state)
            if restored is not None:
                step, state, _ = restored
                return step, state
        return 0, state

    def run(self, on_step=None) -> tuple[Params, list[dict]]:
        start, state = self.init_or_restore()
        history: list[dict] = []
        for step in range(start, self.tcfg.steps):
            batch = data_lib.lm_batch(self.data_cfg, step, self.device)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])   # blocks; timing includes compute
            dt = time.perf_counter() - t0
            rep = self.monitor.report(step, dt)
            rec = {"step": step, "loss": loss, "time_s": dt,
                   "straggler": rep.severity}
            history.append(rec)
            if self.monitor.should_escalate:
                rec["escalate"] = "remesh"   # launcher-level hook
            if on_step:
                on_step(rec)
            if self.ckpt and (step + 1) % self.tcfg.checkpoint_every == 0:
                self.ckpt.save(step + 1, state, {"loss": loss})
        if self.ckpt:
            self.ckpt.save(self.tcfg.steps, state, {"final": True})
        return state, history
