"""Serving step functions of the Bayesian LM: the part of
``repro.serving.server`` the one-shot engine drives (``step_fns``). The
continuous-batching server, its request pool and metrics come with the next
slice of the port.

The decode step runs the fused single-launch executor
(``core.plan.compile_decode_step`` -> ``kernels/fused_decode``) whenever the
config has a fused lowering, with the per-op ``transformer.decode_step``
path as the :class:`FusedPlanUnsupported` fallback — per pool shape, at the
first call with that shape. Prefill is exact or bucketed (the prompt padded
to a length bucket, then trimmed back: equal to the exact form).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Callable

import torch

from repro_torch import device as device_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import uncertainty as unc_lib
from repro_torch.models import transformer

__all__ = ["posterior", "StepFns", "step_fns", "fallback_counts"]

#: Demotions of the fused decode step to the per-op path, keyed by
#: ``(stage, key)``: stage "build" (no fused lowering for the config) or
#: "call" (the kernel wrapper refused a pool shape, key = that shape).
fallback_counts: collections.Counter = collections.Counter()


def posterior(logits: torch.Tensor, n: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mask-sample posterior of one step: logits [n*b, V] (mask-major rows)
    -> (mean log-probs [b, V], relative uncertainty of the argmax token
    [b]); ``core.uncertainty.token_posterior``."""
    return unc_lib.token_posterior(logits, n)


@dataclasses.dataclass(frozen=True)
class StepFns:
    """Serving steps of one config on one device.
    ``prefill(params, tokens [n*b, P], max_seq=M)`` and
    ``decode(params, caches, tokens [n*b, 1], pos)`` both return
    ``(mean_logp [b, V], rel_unc [b], caches)``; ``pos`` is a scalar or
    per-row [n*b]. ``counts`` counts calls by path ("prefill_exact",
    "prefill_bucketed", "decode_fused", "decode_per_op"). ``fused_spec``
    is the decode chain's static key when the fused executor is selected
    (None for per-op); ``fused_state["blocked"]`` holds the pool-shape keys
    that fell back per-op. ``prefill_spec`` is set when the config admits
    bucketed prefill."""
    n_samples: int
    prefill: Callable
    decode: Callable
    counts: collections.Counter
    fused_spec: object | None = None
    fused_state: dict | None = None
    prefill_spec: object | None = None

    def fused_live(self) -> bool:
        """True iff decode runs the fused executor and no pool shape has
        fallen back to the per-op path."""
        return self.fused_spec is not None and \
            not (self.fused_state or {}).get("blocked")


def step_fns(model, expand_masks: bool = True, fused: bool | None = None,
             prefill_buckets: tuple[int, ...] | None = None,
             device: torch.device | str | None = None) -> StepFns:
    """Build (and cache per *config*) the serving steps on ``device`` (None
    -> the card).

    ``expand_masks=True`` is the Bayesian serving form: rows are the mask
    expansion (mask-major groups, row j uses mask ``j // b``); with False
    (or a non-Bayesian config) rows are plain requests and the posterior is
    the single-sample case — the ``generate`` path.

    ``fused``: True requires the fused decode step and surfaces
    ``FusedPlanUnsupported``; False forces per-op; None (default) tries
    fused and falls back per-op only on ``FusedPlanUnsupported`` (at build,
    or at the first call with a pool shape the kernel refuses). Any other
    exception propagates.

    ``prefill_buckets``: None -> the power-of-two set per ``max_seq``; an
    explicit tuple is validated; ``()`` disables bucketing.

    The cache key is the hashable ``ModelConfig`` (plus the options and
    the device), never the ``Model``: building steps must not pin model
    objects. A bare config is accepted in place of a model."""
    cfg = getattr(model, "cfg", model)
    if prefill_buckets is not None:
        prefill_buckets = tuple(int(b) for b in prefill_buckets)
        if prefill_buckets and any(b < 1 for b in prefill_buckets):
            raise ValueError(
                f"non-positive prefill bucket in {prefill_buckets}")
    return _step_fns(cfg, bool(expand_masks), fused, prefill_buckets,
                     device_lib.resolve(device))


@functools.lru_cache(maxsize=None)
def _step_fns(cfg, expand_masks: bool, fused: bool | None,
              buckets: tuple[int, ...] | None,
              device: torch.device) -> StepFns:
    transformer.check_supported(cfg)
    bayes = cfg.bayesian and expand_masks
    n = cfg.mask_samples if bayes else 1
    counts: collections.Counter = collections.Counter()

    def mask_ids(rows: int):
        # non-expanded rows keep the transformer's default assignment
        return (torch.arange(n, device=device).repeat_interleave(rows // n)
                if bayes else None)

    def exact_prefill(params, tokens, max_seq):
        counts["prefill_exact"] += 1
        logits, caches = transformer.prefill(
            cfg, params, {"tokens": tokens}, max_seq=max_seq,
            mask_ids=mask_ids(tokens.shape[0]))
        mean, rel = posterior(logits, n)
        return mean, rel, caches

    prefill_spec = None
    if buckets is None or buckets:
        try:
            prefill_spec = plan_lib.prefill_fused_spec(
                cfg, expand_masks=expand_masks)
        except plan_lib.FusedPlanUnsupported:
            prefill_spec = None

    def prefill(params, tokens, max_seq):
        tokens = torch.as_tensor(tokens, device=device)
        if prefill_spec is None:
            return exact_prefill(params, tokens, max_seq)
        length = tokens.shape[1]
        bucket = plan_lib.prefill_bucket(length, max_seq, buckets)
        if bucket is None:                  # a custom set doesn't cover it
            return exact_prefill(params, tokens, max_seq)
        if bucket > length:
            pad = tokens.new_zeros((tokens.shape[0], bucket - length))
            tokens = torch.cat([tokens, pad], 1)
        counts["prefill_bucketed"] += 1
        step = plan_lib.compile_prefill_step(cfg, bucket, max_seq,
                                             expand_masks=expand_masks)
        return step(params, tokens, length)

    def perop_decode(params, caches, tokens, pos):
        counts["decode_per_op"] += 1
        tokens = torch.as_tensor(tokens, device=device)
        logits, caches = transformer.decode_step(
            cfg, params, caches, tokens, pos,
            mask_ids=mask_ids(tokens.shape[0]))
        mean, rel = posterior(logits, n)
        return mean, rel, caches

    fused_step = fspec = None
    if fused is not False:
        try:
            fspec = plan_lib.decode_fused_spec(cfg, expand_masks=expand_masks)
            fused_step = plan_lib.compile_decode_step(
                cfg, expand_masks=expand_masks, device=device)
        except plan_lib.FusedPlanUnsupported:
            if fused:
                raise
            fallback_counts[("build", "decode")] += 1

    if fused_step is None:
        return StepFns(n_samples=n, prefill=prefill, decode=perop_decode,
                       counts=counts, prefill_spec=prefill_spec)

    state = {"blocked": set()}

    def shape_key(caches, tokens) -> tuple[int, ...]:
        # what the kernel's limits depend on: pool rows and cache lengths
        return (tokens.shape[0],) + tuple(sorted(
            {c["kpos"].shape[-1] for seg in caches for c in seg.values()}))

    def decode(params, caches, tokens, pos):
        key = shape_key(caches, tokens)
        if key not in state["blocked"]:
            try:
                out = fused_step(params, caches, tokens, pos)
                counts["decode_fused"] += 1
                return out
            except plan_lib.FusedPlanUnsupported:
                if fused:
                    raise
                state["blocked"].add(key)
                fallback_counts[("call", str(key))] += 1
        return perop_decode(params, caches, tokens, pos)

    return StepFns(n_samples=n, prefill=prefill, decode=decode,
                   counts=counts, fused_spec=fspec, fused_state=state,
                   prefill_spec=prefill_spec)
