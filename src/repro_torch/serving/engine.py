"""One-shot serving engine: voxel uncertainty (IVIM) and Bayesian LM
generation — the port's ``repro.serving.engine``.

IVIM: a compiled :class:`~repro_torch.core.plan.PackedPlan` is served on a
voxel batch or a whole scan: the voxels stream through one per-chunk moments
runner in fixed-size chunks (the last one zero-padded, so every launch sees
one shape), and the per-chunk (mean, std) are reassembled. By default the
runner is the fused whole-plan kernel with its in-kernel moments epilogue
(one launch per chunk); the per-op executor (one masked_ffn launch per chunk,
then one ``moments`` kernel launch over its samples) is its fallback.

LM: ``generate`` is greedy generation; ``serve_uncertain`` is the paper's
technique at LM scale — every request is evaluated under all N fixed
Masksembles masks (the batch expanded x N once, prefill included), the
per-token prediction is the mean log-probability over the masks and the
per-token uncertainty the relative std of the chosen token. Both drive the
step functions of :mod:`repro_torch.serving.server`: by default one fused
``fused_decode`` launch per emitted token.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable

import torch

from repro_torch import device as device_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import scheduler as scheduler_lib
from repro_torch.core import uncertainty as unc_lib
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import server as server_lib

__all__ = ["plan_chunk_runner", "predict_packed", "predict_volume",
           "fallback_counts", "ServeConfig", "generate",
           "uncertainty_decode_step", "serve_uncertain"]

#: Fallbacks to the per-op executor taken by ``fused=None`` runners, keyed
#: by where the fused path was refused: "build" (no fused lowering) or
#: "call" (the kernel's residency guard, at the first chunk).
fallback_counts: collections.Counter = collections.Counter()


def plan_chunk_runner(plan: plan_lib.PackedPlan, *,
                      fused: bool | None = None,
                      device: torch.device | str | None = None):
    """The per-chunk moments executor of one plan: a callable
    ``xc [chunk, D] -> (mean [chunk, d_out], std)``.

    ``fused=True`` requires the whole-plan kernel with the in-kernel moments
    epilogue and surfaces :class:`plan_lib.FusedPlanUnsupported`;
    ``fused=False`` forces the per-op path (one masked_ffn launch per
    PackedPair, then ``uncertainty.predictive_moments``: one ``moments``
    kernel launch per chunk on the card); ``None`` tries
    fused and falls back per-op only on ``FusedPlanUnsupported`` — at build
    when the plan has no fused lowering, or at the first call when the
    shared-memory residency guard fires (every chunk has one shape, so the
    choice is made once). Any other exception propagates.
    """
    dev = device_lib.resolve(device)
    plan = plan.to(dev)

    def per_op(xc):
        return unc_lib.predictive_moments(
            plan_lib.execute(plan, xc, device=dev))

    if fused is False:
        return per_op
    try:
        run = plan_lib.fused_executor(plan, moments=True, device=dev)
    except plan_lib.FusedPlanUnsupported:
        if fused:
            raise
        fallback_counts["build"] += 1
        server_lib._note_fallback("build", "plan")
        return per_op
    if fused:
        return run

    state: dict[str, Callable] = {}

    def runner(xc):
        fn = state.get("fn")
        if fn is not None:
            return fn(xc)
        try:
            out = run(xc)          # the residency guard fires here
        except plan_lib.FusedPlanUnsupported:
            fallback_counts["call"] += 1
            server_lib._note_fallback("call", "plan")
            state["fn"] = per_op
            return per_op(xc)
        state["fn"] = run
        return out

    return runner


def predict_packed(plan: plan_lib.PackedPlan, x: torch.Tensor, *,
                   chunk: int | None = None, fused: bool | None = None,
                   device: torch.device | str | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Serve a compiled PackedPlan on a voxel batch: x [B, D] ->
    (mean [B, d_out], std [B, d_out]) on ``device`` (None -> the card).

    ``fused`` selects the executor as in :func:`plan_chunk_runner`.
    ``chunk`` bounds the resident batch: the voxels stream through one
    runner in ``chunk``-row slices (``scheduler.chunk_bounds``, the last
    slice zero-padded to the chunk shape, pad rows dropped), so each chunk
    is exactly one fused launch — or, per-op, one masked_ffn and one
    ``moments`` launch.
    """
    dev = device_lib.resolve(device)
    plan = plan.to(dev)
    x = x.to(dev)
    b = x.shape[0]
    if chunk is None or chunk >= b:
        if fused is not False:
            try:
                run = plan_lib.fused_executor(plan, moments=True, device=dev)
                return run(x)
            except plan_lib.FusedPlanUnsupported:
                if fused:
                    raise
        return unc_lib.predictive_moments(
            plan_lib.execute(plan, x, device=dev))

    runner = plan_chunk_runner(plan, fused=fused, device=dev)
    means, stds = [], []
    for lo, hi in scheduler_lib.chunk_bounds(b, chunk):
        xc = x[lo:hi]
        if hi - lo < chunk:
            pad = x.new_zeros((chunk - (hi - lo),) + tuple(x.shape[1:]))
            xc = torch.cat([xc, pad])
        mean, std = runner(xc)
        means.append(mean)
        stds.append(std)
    return torch.cat(means)[:b], torch.cat(stds)[:b]


def predict_volume(plan: plan_lib.PackedPlan, volume: torch.Tensor, *,
                   chunk: int = 4096, fused: bool | None = None,
                   device: torch.device | str | None = None, server=None,
                   priority: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Stream a clinical scan through the executor: volume [..., D] (e.g.
    ``[X, Y, Z, n_bvalues]``) -> (mean, std), each ``[..., d_out]``. The
    voxel grid is flattened, served by :func:`predict_packed` in fixed
    ``chunk``-voxel slices and reshaped back to the scan's layout.

    With ``server=`` (a :class:`repro_torch.serving.server.BayesianLMServer`)
    this becomes a thin pool client, on the server's device: the scan is
    submitted as one voxel-chunk work item (``server.submit_scan`` —
    sharing the LM requests' admission queue, backpressure and escalation
    policy at ``priority``), the server drains, and the reassembled moments
    come back bitwise equal to the direct path (both run the one
    :func:`plan_chunk_runner` executor over the same
    ``core.scheduler.chunk_bounds`` partition)."""
    if volume.ndim < 2:
        raise ValueError(f"volume must be [..., D], got {tuple(volume.shape)}")
    lead = tuple(volume.shape[:-1])
    x = volume.reshape(-1, volume.shape[-1])
    with obs_trace.TRACER.span("predict_volume", n_voxels=int(x.shape[0]),
                               chunk=chunk, pooled=server is not None):
        if server is not None:
            rid = server.submit_scan(plan, x, chunk=chunk, priority=priority,
                                     fused=fused)
            server.run()
            mean, std = server.result(rid).scan_moments()
        else:
            mean, std = predict_packed(plan, x, chunk=chunk, fused=fused,
                                       device=device)
    return (mean.reshape(lead + (mean.shape[-1],)),
            std.reshape(lead + (std.shape[-1],)))


# ---------------------------------------------------------------------------
# Bayesian LM serving
# ---------------------------------------------------------------------------

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_new_tokens: int = 16
    greedy: bool = True
    uncertainty_threshold: float = 0.5   # flag tokens above this rel-unc
    fused: bool | None = None            # decode executor (True = require
                                         # fused, False = per-op, None =
                                         # auto with per-op fallback)


@torch.no_grad()
def generate(model, params: Params, tokens: torch.Tensor,
             cfg: ServeConfig = ServeConfig(), *, mesh=None,
             device: torch.device | str | None = None) -> torch.Tensor:
    """Greedy generation: tokens [B, S] -> [B, S + max_new_tokens] (int32)
    on ``device`` (None -> the card), where ``params`` must live (plain
    tensors, or DTensors on ``mesh`` as :func:`serve_uncertain` takes
    them)."""
    dev = device_lib.resolve(device)
    tokens = torch.as_tensor(tokens, device=dev).to(torch.int32)
    s = tokens.shape[1]
    fns = server_lib.step_fns(model, expand_masks=False, fused=cfg.fused,
                              device=dev)
    with server_lib.mesh_scope(mesh):
        mean, _, cache = fns.prefill(params, tokens,
                                     max_seq=s + cfg.max_new_tokens)
        out = [mean.argmax(-1).to(torch.int32)]
        for i in range(cfg.max_new_tokens - 1):
            mean, _, cache = fns.decode(params, cache, out[-1][:, None],
                                        s + i)
            out.append(mean.argmax(-1).to(torch.int32))
    return torch.cat([tokens, torch.stack(out, 1)], 1)


def _expand_for_masks(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.repeat((n,) + (1,) * (x.ndim - 1))


@torch.no_grad()
def uncertainty_decode_step(model, params: Params, caches,
                            tokens: torch.Tensor, pos):
    """One Bayesian decode step on a mask-expanded batch [N*B, 1], per-op:
    row j uses mask j // B. Returns (mean_logprobs [B, V],
    rel_uncertainty [B], new caches) — the plain form of the server's
    decode step."""
    from repro_torch.models import transformer
    cfg = model.cfg
    n = max(cfg.mask_samples, 1)
    ids = (torch.arange(n, device=tokens.device)
           .repeat_interleave(tokens.shape[0] // n) if cfg.bayesian
           else None)
    logits, caches = transformer.decode_step(cfg, params, caches, tokens,
                                             pos, mask_ids=ids)
    mean, rel = server_lib.posterior(logits, n)
    return mean, rel, caches


@torch.no_grad()
def serve_uncertain(model, params: Params, tokens: torch.Tensor,
                    cfg: ServeConfig = ServeConfig(), *, mesh=None,
                    device: torch.device | str | None = None):
    """Bayesian generation with per-token uncertainty, on ``device`` (None
    -> the card), where ``params`` must live: plain tensors, or DTensors on
    ``mesh`` laid out by ``sharding.param_shardings`` (the per-op steps run
    on them with caches laid out by ``cache_shardings``; the fused step
    gathers each parameter once, ``core.plan.compile_decode_step``).

    Returns (generated [B, S+T] int32, rel_uncertainty [B, T],
    flags [B, T]). The request batch is expanded x N once (prefill
    included): every decode step reads the weights once for all N·B rows.
    """
    if not model.cfg.bayesian:
        raise ValueError("serve_uncertain requires mask_samples > 0")
    dev = device_lib.resolve(device)
    n = model.cfg.mask_samples
    tokens = torch.as_tensor(tokens, device=dev).to(torch.int32)
    s = tokens.shape[1]
    fns = server_lib.step_fns(model, fused=cfg.fused, device=dev)
    outs, uncs = [], []
    # Each step's rel-uncertainty describes the argmax of the distribution
    # it produced, i.e. the NEXT emitted token: token i pairs with the
    # uncertainty of the step that chose it (prefill for token 0), and the
    # last decode's (an un-emitted token) is dropped.
    with server_lib.mesh_scope(mesh):
        mean, unc_next, caches = fns.prefill(
            params, _expand_for_masks(tokens, n),
            max_seq=s + cfg.max_new_tokens)
        cur = mean.argmax(-1).to(torch.int32)
        for i in range(cfg.max_new_tokens):
            outs.append(cur)
            uncs.append(unc_next)
            mean, unc_next, caches = fns.decode(
                params, caches, _expand_for_masks(cur, n)[:, None], s + i)
            cur = mean.argmax(-1).to(torch.int32)
    gen = torch.cat([tokens, torch.stack(outs, 1)], 1)
    unc = torch.stack(uncs, 1)
    return gen, unc, unc > cfg.uncertainty_threshold
