"""Continuous-batching Bayesian LM server — the paper's uncertainty pathway
as a *service*, not a function call (the port's twin of
``repro.serving.server``).

The one-shot engine (serving/engine.py) evaluates a fixed request batch to
completion; real traffic arrives as a stream. This module adds the request
layer that lets the batch-level mask schedule (paper Fig. 5) amortize across
that stream:

* **admission queue** — ``submit()`` enqueues a :class:`Request` under a
  priority heap with ``max_queue`` backpressure (:class:`QueueFullError`);
  ``submit_scan()`` enqueues a clinical scan (:class:`VoxelScanRequest`)
  into the same queue;
* **slot pool** — one KV/state cache of ``n_masks x max_slots`` batch rows,
  laid out by :class:`repro_torch.core.scheduler.SlotSchedule` (mask-major:
  a request owns the ``n_masks`` rows of one slot). Finished requests free
  their slot group; waiting requests are prefilled into free slots while
  in-flight requests keep decoding — continuous batching;
* **fixed-shape steps** — :func:`step_fns` builds the ``prefill`` (exact or
  length-bucketed) and ``decode`` steps once per config; the decode step
  runs the fused single-launch executor (``core.plan.compile_decode_step``
  -> ``kernels/fused_decode``, one launch a step) whenever the config has a
  fused lowering, with the per-op ``transformer.decode_step`` path as the
  :class:`FusedPlanUnsupported` fallback — per pool shape, at the first
  call with that shape. Each build is counted in ``core.plan.build_counts``,
  which a warm serving loop leaves flat;
* **first-class uncertainty** — every decode step returns the per-request
  relative uncertainty; consecutive flagged tokens drive per-request
  escalation state, and the policy can early-terminate (``"terminate"``) or
  preempt + down-prioritize (``"deprioritize"``) flagged requests — the
  paper's §VI-B clinical escalation pathway applied to scheduling.

Pool rows are computed batch-independently, so resident requests cannot
perturb each other's tokens beyond the order of a kernel's floating-point
sums. Time is read only through the injectable clock (the metrics
collector's, default ``obs.trace.default_clock``).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import heapq
import itertools
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import scheduler as scheduler_lib
from repro_torch.core import uncertainty as unc_lib
from repro_torch.models import transformer
from repro_torch.obs import profile as obs_profile
from repro_torch.obs import registry as obs_registry
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.metrics import MetricsCollector, ServingSummary

Params = dict[str, Any]

__all__ = ["posterior", "StepFns", "step_fns", "fallback_counts",
           "QueueFullError", "Request", "VoxelScanRequest", "WorkItem",
           "RequestState", "ServerConfig", "BayesianLMServer"]

#: Demotions of the fused decode step to the per-op path, keyed by
#: ``(stage, key)``: stage "build" (no fused lowering for the config) or
#: "call" (the kernel wrapper refused a pool shape, key = that shape).
fallback_counts: collections.Counter = collections.Counter()

# -- serving telemetry (process registry; see repro_torch/obs/registry.py) --
_REJECTS = obs_registry.REGISTRY.counter(
    "serving_queue_rejections_total",
    "admissions refused by max_queue backpressure", labels=("modality",))
_PREEMPTS = obs_registry.REGISTRY.counter(
    "serving_preemptions_total",
    "running work items bounced back to the queue", labels=("policy",))
_FALLBACKS = obs_registry.REGISTRY.counter(
    "fused_fallback_total",
    "fused-executor demotions to the per-op path, by stage (build = no "
    "fused lowering for the config; call = a kernel wrapper refused a "
    "concrete shape) and key", labels=("stage", "key"))


def _note_fallback(stage: str, key: str) -> None:
    """Record one fused->per-op demotion on the registry and the process
    tracer; shared with ``engine.plan_chunk_runner``."""
    _FALLBACKS.inc(stage=stage, key=key)
    obs_trace.TRACER.event("fused_fallback", stage=stage, key=key)


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
    plan_lib.build_counts[("step_fns", cfg, expand_masks, fused, buckets,
                           device)] += 1
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
        length = tokens.shape[1]
        bucket = None if prefill_spec is None else \
            plan_lib.prefill_bucket(length, max_seq, buckets)
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("prefill", path="exact" if bucket is None
                     else "bucketed", bucket=bucket, length=int(length))
        if bucket is None:      # no bucketed form, or no bucket covers it
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
            _note_fallback("build", "decode")

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
                _note_fallback("call", str(key))
        return perop_decode(params, caches, tokens, pos)

    return StepFns(n_samples=n, prefill=prefill, decode=decode,
                   counts=counts, fused_spec=fspec, fused_state=state,
                   prefill_spec=prefill_spec)


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------


class QueueFullError(RuntimeError):
    """Admission queue at ``max_queue`` — backpressure; caller retries or
    sheds load."""


@dataclasses.dataclass(frozen=True)
class Request:
    """One LM generation request (work-item kind ``"lm"``).
    ``priority``: lower value = served first."""
    req_id: int
    tokens: tuple[int, ...]
    max_new_tokens: int
    priority: int = 0

    kind = "lm"


@dataclasses.dataclass(frozen=True)
class VoxelScanRequest:
    """One clinical-scan request (work-item kind ``"voxel"``): a flattened
    voxel batch served through the pool one fixed-size chunk per engine
    step.

    ``x`` is the scan's ``[n_voxels, D]`` signal matrix on the server's
    device; ``bounds`` the ``core.scheduler.chunk_bounds`` partition;
    ``runner`` the per-chunk moments executor (``engine.plan_chunk_runner``
    — the SAME callable the direct ``engine.predict_volume`` path runs,
    which is what makes pooled results bitwise equal to the direct path). A
    resident scan occupies one slot and advances one chunk per ``step()``;
    preemption (deprioritize) re-queues it and it resumes at its next
    unprocessed chunk, so chunks of one scan never complete out of order.
    """
    req_id: int
    x: Any
    chunk: int
    bounds: tuple[tuple[int, int], ...]
    runner: Callable
    priority: int = 0

    kind = "voxel"

    @property
    def n_voxels(self) -> int:
        return self.x.shape[0]


#: A pool work item — both kinds share the priority queue, the
#: ``max_queue`` backpressure, the escalation-policy surface and the
#: metrics stream (per-modality labels).
WorkItem = Request | VoxelScanRequest


@dataclasses.dataclass
class RequestState:
    """Mutable serving state + final result of one work item.

    status: queued -> running -> done (or "escalated" when the uncertainty
    policy terminated it early; "deprioritize" preemption bounces it back
    to queued).

    LM items fill ``generated``/``pending``; voxel items fill
    ``chunk_results`` (per-chunk ``(mean, std)`` tensors, strictly in chunk
    order — the resume cursor is ``len(chunk_results)``).
    ``uncertainty``/``flags`` hold per-token rel-unc for LM items and
    per-chunk max voxel rel-unc for scans; the escalation policy reads them
    identically."""
    request: WorkItem
    status: str = "queued"
    slot: int | None = None
    effective_priority: int = 0
    generated: list[int] = dataclasses.field(default_factory=list)
    uncertainty: list[float] = dataclasses.field(default_factory=list)
    flags: list[bool] = dataclasses.field(default_factory=list)
    flag_streak: int = 0
    escalated: bool = False
    preempts: int = 0
    pending: int | None = None    # next token to feed through decode
    pending_unc: float = 0.0      # rel-unc of pending (from the step that
                                  # chose it; recorded when it is emitted)
    chunk_results: list = dataclasses.field(default_factory=list)

    @property
    def kind(self) -> str:
        return self.request.kind

    @property
    def next_pos(self) -> int:
        """Decode position of the pending token: prompt + emitted so far
        (invariant across preemption — re-prefill re-encodes exactly the
        first ``next_pos`` positions)."""
        return len(self.request.tokens) + len(self.generated)

    def scan_moments(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Reassemble a finished scan: concatenate the per-chunk moments,
        strip the zero-pad tail -> (mean [n_voxels, d_out], std)."""
        if self.kind != "voxel":
            raise ValueError(f"work item {self.request.req_id} is "
                             f"{self.kind}, not a voxel scan")
        if self.status != "done":
            raise ValueError(
                f"scan {self.request.req_id} is {self.status}; only "
                f"completed scans reassemble (escalation policy "
                f"'terminate' leaves partial results in chunk_results)")
        b = self.request.n_voxels
        mean = torch.cat([m for m, _ in self.chunk_results])[:b]
        std = torch.cat([s for _, s in self.chunk_results])[:b]
        return mean, std


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    max_slots: int = 4
    max_queue: int = 64
    max_prompt_len: int = 32
    max_new_tokens: int = 16          # per-request cap; requests may ask less
    uncertainty_threshold: float = 0.5
    escalation_patience: int = 2      # consecutive flagged tokens to escalate
    escalation_policy: str = "flag"   # flag | terminate | deprioritize
    deprioritize_penalty: int = 10    # priority added on escalation preempt
    fused: bool | None = None         # decode executor: True = require the
                                      # fused single-launch step, False =
                                      # per-op, None = auto w/ fallback
    prefill_buckets: tuple[int, ...] | None = None
                                      # admission prefill length buckets:
                                      # None = power-of-two auto set,
                                      # () = exact per-length prefill
    kv_dtype: str = ""                # pool KV storage: "" = inherit the
                                      # model config's kv_dtype, "bfloat16"
                                      # (fused-decode supported), "int8"
                                      # (+ per-vector scales; decode runs
                                      # the per-op path)
    trace: bool = False               # enable span tracing on the process
                                      # tracer (obs.trace.TRACER) — one
                                      # record per lifecycle event; off by
                                      # default (zero hot-path appends)

    def __post_init__(self) -> None:
        if self.escalation_policy not in ("flag", "terminate",
                                          "deprioritize"):
            raise ValueError(
                f"unknown escalation policy {self.escalation_policy!r}")
        if self.max_slots < 1:
            raise ValueError(f"max_slots {self.max_slots} < 1")
        if self.max_queue < self.max_slots:
            # fewer queue seats than slots means backpressure rejects
            # traffic the pool could already hold
            raise ValueError(
                f"max_queue {self.max_queue} < max_slots {self.max_slots}: "
                f"the admission queue must at least cover the pool")
        if self.max_prompt_len < 1 or self.max_new_tokens < 1:
            raise ValueError(
                f"max_prompt_len {self.max_prompt_len} and max_new_tokens "
                f"{self.max_new_tokens} must be >= 1")
        if self.kv_dtype not in ("", "bfloat16", "int8"):
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r}")
        if self.prefill_buckets is not None:
            # normalize (frozen dataclass: bypass immutability once) and
            # validate loudly — a non-positive bucket would otherwise
            # surface as a shape error deep inside the first admission
            vals = tuple(int(b) for b in self.prefill_buckets)
            object.__setattr__(self, "prefill_buckets", vals)
            if vals:      # () = bucketing disabled, valid
                plan_lib.prefill_buckets(self.max_seq, vals)

    @property
    def max_seq(self) -> int:
        return self.max_prompt_len + self.max_new_tokens


class BayesianLMServer:
    """Continuous-batching server over one Bayesian model, on ``device``
    (None -> the card; ``params`` must live there).

        server = BayesianLMServer(model, params, ServerConfig(max_slots=4))
        rid = server.submit(prompt_tokens, max_new_tokens=12)
        summary = server.run()            # drain queue + slots
        state = server.result(rid)        # tokens, per-token uncertainty

    ``step()`` is one engine iteration — admit waiting requests into free
    slots (prefill + scatter into the pool), then one decode over the whole
    pool and one chunk of each resident scan — so a caller can also
    interleave ``submit``/``step`` to replay a live arrival trace.
    """

    def __init__(self, model, params: Params,
                 cfg: ServerConfig = ServerConfig(), *,
                 device: torch.device | str | None = None,
                 clock: Callable[[], float] | None = None,
                 tracer: obs_trace.Tracer | None = None) -> None:
        if not model.cfg.bayesian:
            raise ValueError("BayesianLMServer requires mask_samples > 0")
        self.device = device_lib.resolve(device)
        # The cached step closures are process-global, so the default
        # tracer is the process TRACER; cfg.trace=True switches it on.
        self._tracer = obs_trace.TRACER if tracer is None else tracer
        if cfg.trace:
            self._tracer.enable()
        self.model, self.params, self.cfg = model, params, cfg
        self.schedule = scheduler_lib.SlotSchedule(model.cfg.mask_samples,
                                                   cfg.max_slots)
        # cfg.kv_dtype rewrites the MODEL config the steps/caches build
        # against ("" inherits whatever the model config already says)
        mcfg = model.cfg
        if cfg.kv_dtype and cfg.kv_dtype != mcfg.kv_dtype:
            mcfg = dataclasses.replace(mcfg, kv_dtype=cfg.kv_dtype)
        self.model_cfg = mcfg
        self.steps = step_fns(mcfg, fused=cfg.fused,
                              prefill_buckets=cfg.prefill_buckets,
                              device=self.device)
        self._caches = transformer.init_cache(mcfg, self.schedule.rows,
                                              cfg.max_seq, device=self.device)
        self._slots: list[int | None] = [None] * cfg.max_slots
        self._queue: list[tuple[int, int, int]] = []   # (prio, seq, req_id)
        self._seq = itertools.count()
        self._ids = itertools.count()
        self._cancelled: set[int] = set()   # heap tombstones (cancel())
        self.states: dict[int, RequestState] = {}
        self.metrics = MetricsCollector(cfg.max_slots, clock)

    # ---- admission ---------------------------------------------------------
    def _claim_id(self, req_id: int | None) -> int:
        """Next id from the server counter, or the caller-pinned one (the
        multi-host router keeps ONE global id space across per-host
        servers by pinning, so a failover resubmission keeps its id)."""
        if req_id is None:
            return next(self._ids)
        rid = int(req_id)
        if rid in self.states:
            raise ValueError(f"req_id {rid} is already tracked by this "
                             f"server ({self.states[rid].status})")
        return rid

    def submit(self, tokens, *, max_new_tokens: int | None = None,
               priority: int = 0, req_id: int | None = None) -> int:
        """Enqueue ONE prompt (a 1-D token sequence — submit a batch as
        separate requests); returns the request id. Raises QueueFullError
        when the admission queue is at max_queue (backpressure).
        ``req_id`` pins the id instead of drawing from the server counter
        (router failover resubmits under the original global id)."""
        arr = np.asarray(tokens.cpu() if isinstance(tokens, torch.Tensor)
                         else tokens)
        if arr.ndim > 1:
            raise ValueError(f"submit takes one prompt, got shape "
                             f"{arr.shape}; submit batch rows separately")
        toks = tuple(int(t) for t in arr.reshape(-1))
        if not 1 <= len(toks) <= self.cfg.max_prompt_len:
            raise ValueError(f"prompt length {len(toks)} outside "
                             f"[1, {self.cfg.max_prompt_len}]")
        if self.queue_depth >= self.cfg.max_queue:
            _REJECTS.inc(modality="lm")
            self._tracer.event("reject", kind="lm")
            raise QueueFullError(
                f"admission queue full ({self.cfg.max_queue})")
        mnt = self.cfg.max_new_tokens if max_new_tokens is None \
            else max_new_tokens
        if not 1 <= mnt <= self.cfg.max_new_tokens:
            raise ValueError(f"max_new_tokens {mnt} outside "
                             f"[1, {self.cfg.max_new_tokens}]")
        rid = self._claim_id(req_id)
        st = RequestState(Request(rid, toks, mnt, priority),
                          effective_priority=priority)
        self.states[rid] = st
        heapq.heappush(self._queue, (priority, next(self._seq), rid))
        self.metrics.on_enqueue(rid)
        self._tracer.event("enqueue", req_id=rid, kind="lm",
                           prompt_len=len(toks), priority=priority,
                           queue_depth=self.queue_depth)
        return rid

    def submit_scan(self, plan, x, *, chunk: int = 4096, priority: int = 0,
                    fused: bool | None = None, req_id: int | None = None,
                    resume_results: list | None = None) -> int:
        """Enqueue ONE clinical scan (a compiled ``core.plan.PackedPlan``
        plus its flattened ``[n_voxels, D]`` voxel batch) as a voxel-chunk
        work item; returns the request id.

        The scan shares the LM requests' priority queue and ``max_queue``
        backpressure; resident, it occupies one slot and advances one
        zero-padded ``chunk``-voxel moments launch per engine step — the
        same per-chunk executor the direct ``engine.predict_volume`` path
        runs, so a completed scan's ``scan_moments()`` is bitwise equal to
        the direct path. Admission requires the plan's sample axis to map
        onto the pool layout (``plan.slot_schedule == pool schedule``, i.e.
        matching n_masks).

        ``req_id`` pins the id (see :meth:`submit`); ``resume_results``
        seeds the chunk cursor with moments already computed elsewhere —
        router failover resubmits a scan from a dead host this way, and it
        resumes at ``len(chunk_results)`` exactly as ``_preempt``
        re-admission does on one server (chunks never recompute and never
        complete out of order)."""
        # lazy import: engine imports this module at its top level
        from repro_torch.serving import engine as engine_lib
        self.schedule.admits(plan.slot_schedule(self.cfg.max_slots))
        x = torch.as_tensor(x, device=self.device)
        if x.ndim != 2:
            raise ValueError(f"scan must be [n_voxels, D], got "
                             f"{tuple(x.shape)}")
        if self.queue_depth >= self.cfg.max_queue:
            _REJECTS.inc(modality="voxel")
            self._tracer.event("reject", kind="voxel")
            raise QueueFullError(
                f"admission queue full ({self.cfg.max_queue})")
        bounds = scheduler_lib.chunk_bounds(x.shape[0], chunk)
        if resume_results is not None and \
                len(resume_results) >= len(bounds):
            raise ValueError(
                f"resume_results carries {len(resume_results)} chunks but "
                f"the scan only has {len(bounds)}: nothing left to run")
        runner = engine_lib.plan_chunk_runner(plan, fused=fused,
                                              device=self.device)
        rid = self._claim_id(req_id)
        st = RequestState(VoxelScanRequest(rid, x, chunk, bounds, runner,
                                           priority),
                          effective_priority=priority)
        if resume_results:
            st.chunk_results = list(resume_results)
        self.states[rid] = st
        heapq.heappush(self._queue, (priority, next(self._seq), rid))
        self.metrics.on_enqueue(rid, modality="voxel")
        self._tracer.event("enqueue", req_id=rid, kind="voxel",
                           n_voxels=int(x.shape[0]), priority=priority,
                           resumed_chunks=len(resume_results or ()),
                           queue_depth=self.queue_depth)
        return rid

    def cancel(self, req_id: int) -> None:
        """Withdraw a QUEUED work item (the router's drain hook): its state
        is evicted and its heap entry becomes a tombstone the admission
        loop skips. Running or
        finished items cannot be cancelled — preemption is the policy
        surface for resident work."""
        st = self.states.get(req_id)
        if st is None or st.status != "queued":
            raise ValueError(
                f"request {req_id} is "
                f"{'unknown' if st is None else st.status}, not queued")
        kind = st.kind
        del self.states[req_id]
        self._cancelled.add(req_id)
        self._tracer.event("cancel", req_id=req_id, kind=kind)

    @property
    def queue_depth(self) -> int:
        # cancelled entries linger in the heap as tombstones until popped
        return len(self._queue) - len(self._cancelled)

    @property
    def occupied_slots(self) -> int:
        return sum(s is not None for s in self._slots)

    def result(self, req_id: int) -> RequestState:
        return self.states[req_id]

    def pop_result(self, req_id: int) -> RequestState:
        """Return and evict a finished request's state — long-running
        servers call this per completion to keep memory bounded (``result``
        keeps states resident forever). The metrics timeline (a few floats)
        stays so ``summary()`` still covers the whole run."""
        st = self.states[req_id]
        if st.status not in ("done", "escalated"):
            raise ValueError(f"request {req_id} is still {st.status}")
        del self.states[req_id]
        return st

    # ---- slot lifecycle ----------------------------------------------------
    def _admit(self, req_id: int, slot: int) -> None:
        """Bind one queued work item to a free slot. LM requests prefill and
        scatter their cache rows into the slot group — in-flight slots are
        untouched and keep decoding. Voxel scans touch no pool cache (their
        state is the chunk cursor); the slot is pure scheduling capacity."""
        st = self.states[req_id]
        with self._tracer.span("admit", req_id=req_id, slot=slot,
                               kind=st.kind, resumed=st.preempts > 0):
            if st.kind == "voxel":
                st.status, st.slot = "running", slot
                self._slots[slot] = req_id
                if st.preempts == 0:
                    self.metrics.on_admit(req_id)
                return
            ctx = list(st.request.tokens) + st.generated  # re-entry after
            xt = torch.tensor(ctx, dtype=torch.int32,     # preempt
                              device=self.device)[None] \
                .repeat(self.schedule.n_masks, 1)
            mean, rel, fresh = self.steps.prefill(
                self.params, xt, max_seq=self.cfg.max_seq)
            self._caches = transformer.cache_scatter_rows(
                self._caches, fresh,
                self.schedule.rows_for_slot(slot, device=self.device))
            st.pending = int(mean[0].argmax())
            st.pending_unc = float(rel[0])
            st.status, st.slot = "running", slot
            self._slots[slot] = req_id
            if st.preempts == 0:
                self.metrics.on_admit(req_id)
                self.metrics.on_first_token(req_id)  # computed by prefill

    def _release_slot(self, slot: int) -> None:
        """Free a slot group: clear host state and reset its cache rows
        (k/v and recurrent state zero, kpos -1) so unoccupied groups stay
        observably empty."""
        self._slots[slot] = None
        mask = torch.zeros(self.schedule.rows, dtype=torch.bool)
        mask[self.schedule.rows_for_slot(slot)] = True
        self._caches = transformer.cache_reset_rows(
            self._caches, mask.to(self.device))

    def _finish(self, st: RequestState, *, terminated: bool) -> None:
        st.status = "escalated" if terminated else "done"
        self._release_slot(st.slot)
        st.slot, st.pending = None, None
        self.metrics.on_finish(st.request.req_id, escalated=st.escalated)
        self._tracer.event("finish", req_id=st.request.req_id,
                           status=st.status, kind=st.kind)

    def _preempt(self, st: RequestState) -> None:
        """Deprioritize policy: bounce an escalated request back to the queue
        (its slot goes to calmer traffic); it resumes later by re-prefilling
        prompt + generated-so-far at a worse priority."""
        self._release_slot(st.slot)
        st.slot, st.status = None, "queued"
        st.preempts += 1
        st.effective_priority += self.cfg.deprioritize_penalty
        heapq.heappush(self._queue, (st.effective_priority, next(self._seq),
                                     st.request.req_id))
        _PREEMPTS.inc(policy=self.cfg.escalation_policy)
        self._tracer.event("preempt", req_id=st.request.req_id,
                           priority=st.effective_priority)

    # ---- the engine iteration ----------------------------------------------
    def step(self) -> bool:
        """Admit waiting work items into free slots, then run one engine
        iteration across the pool: one decode step over every resident LM
        slot (voxel and empty slots ride along at pos -1) plus one
        moments-chunk launch per resident voxel scan. Returns False once
        fully idle."""
        while self._queue and None in self._slots:
            _, _, rid = heapq.heappop(self._queue)
            if rid in self._cancelled:        # tombstone left by cancel()
                self._cancelled.discard(rid)
                continue
            self._admit(rid, self._slots.index(None))
        occupied = [(slot, rid) for slot, rid in enumerate(self._slots)
                    if rid is not None]
        if not occupied:
            return False
        lm = [(s, r) for s, r in occupied
              if self.states[r].kind == "lm"]
        voxel = [(s, r) for s, r in occupied
                 if self.states[r].kind == "voxel"]
        self.metrics.on_step(len(occupied), self.queue_depth,
                             voxel_occupied=len(voxel))

        with self._tracer.span("step", lm=len(lm), voxel=len(voxel),
                               queue_depth=self.queue_depth), \
                obs_profile.annotate("serving.step"):
            if lm:
                # Inactive slots decode at pos -1: their (garbage) K/V write
                # lands on a kpos=-1 slot, so unoccupied rows stay observably
                # empty — voxel-occupied slots never touch the pool cache and
                # ride along exactly like empty ones.
                tok = np.zeros(self.cfg.max_slots, np.int32)
                pos = np.full(self.cfg.max_slots, -1, np.int32)
                for slot, rid in lm:
                    st = self.states[rid]
                    tok[slot] = st.pending
                    pos[slot] = st.next_pos
                rows_tok = self.schedule.row_values(
                    torch.from_numpy(tok)).to(self.device)[:, None]
                rows_pos = self.schedule.row_values(
                    torch.from_numpy(pos)).to(self.device)
                if self._tracer.enabled:
                    self._tracer.event("decode", rows=self.schedule.rows,
                                       slots=len(lm),
                                       fused=self.steps.fused_live())
                mean, rel, self._caches = self.steps.decode(
                    self.params, self._caches, rows_tok, rows_pos)
                nxt = mean.argmax(-1).cpu().numpy()
                rel = rel.float().cpu().numpy()
                for slot, rid in lm:
                    self._absorb(self.states[rid], int(nxt[slot]),
                                 float(rel[slot]))
            for _, rid in voxel:
                self._advance_scan(self.states[rid])
        return True

    def _advance_scan(self, st: RequestState) -> None:
        """Run one chunk of a resident scan through its per-chunk moments
        executor and fold the result into scan state. The chunk slice is
        zero-padded to exactly ``chunk`` rows — the padding rule of the
        direct ``engine.predict_volume`` path, so pooled and direct moments
        are bitwise equal."""
        req = st.request
        lo, hi = req.bounds[len(st.chunk_results)]
        xc = req.x[lo:hi]
        if hi - lo < req.chunk:
            pad = xc.new_zeros((req.chunk - (hi - lo),) + tuple(xc.shape[1:]))
            xc = torch.cat([xc, pad])
        mean, std = req.runner(xc)
        # Chunk-level uncertainty signal for the shared escalation policy:
        # the worst per-voxel relative uncertainty (max over valid voxels
        # and output columns) — "any voxel uncertain => flag the chunk".
        valid = hi - lo
        rel = float((std[:valid] / mean[:valid].abs().clamp_min(
            unc_lib.REL_UNC_EPS)).max())
        st.chunk_results.append((mean, std))
        if self._tracer.enabled:
            self._tracer.event("chunk", req_id=req.req_id,
                               index=len(st.chunk_results) - 1,
                               voxels=valid, rel=rel)
        self._absorb_chunk(st, rel, n_voxels=valid)

    def _absorb(self, st: RequestState, next_tok: int, rel: float) -> None:
        """Fold one decode result into request state: the pending token is
        now emitted with the uncertainty of the step that *chose* it; this
        step's ``rel`` describes ``next_tok`` and travels with it. The
        escalation policy therefore acts on the emitted token's own
        uncertainty."""
        cfg = self.cfg
        st.generated.append(st.pending)
        st.uncertainty.append(st.pending_unc)
        flagged = st.pending_unc > cfg.uncertainty_threshold
        st.flags.append(flagged)
        st.flag_streak = st.flag_streak + 1 if flagged else 0
        st.pending = next_tok
        st.pending_unc = rel
        self.metrics.on_token(st.request.req_id)
        if self._tracer.enabled:
            self._tracer.event("token", req_id=st.request.req_id,
                               token=st.generated[-1],
                               rel=st.uncertainty[-1], flagged=flagged)
        newly = not st.escalated and \
            st.flag_streak >= cfg.escalation_patience
        if newly:
            st.escalated = True
            self._tracer.event("escalate", req_id=st.request.req_id,
                               policy=cfg.escalation_policy)
        if st.escalated and cfg.escalation_policy == "terminate":
            self._finish(st, terminated=True)
        elif len(st.generated) >= st.request.max_new_tokens:
            self._finish(st, terminated=False)
        elif newly and cfg.escalation_policy == "deprioritize" and \
                self._queue:
            self._preempt(st)

    def _absorb_chunk(self, st: RequestState, rel: float,
                      n_voxels: int) -> None:
        """Fold one completed scan chunk into work-item state — the voxel
        twin of :meth:`_absorb`, driving the SAME escalation surface:
        chunk-level flags feed the streak counter, ``terminate`` stops the
        scan early (partial ``chunk_results``), ``deprioritize`` preempts
        it between chunks (it resumes in order at ``len(chunk_results)``)."""
        cfg = self.cfg
        flagged = rel > cfg.uncertainty_threshold
        st.uncertainty.append(rel)
        st.flags.append(flagged)
        st.flag_streak = st.flag_streak + 1 if flagged else 0
        self.metrics.on_token(st.request.req_id, units=n_voxels)
        newly = not st.escalated and \
            st.flag_streak >= cfg.escalation_patience
        if newly:
            st.escalated = True
            self._tracer.event("escalate", req_id=st.request.req_id,
                               policy=cfg.escalation_policy)
        if st.escalated and cfg.escalation_policy == "terminate":
            self._finish(st, terminated=True)
        elif len(st.chunk_results) >= len(st.request.bounds):
            self._finish(st, terminated=False)
        elif newly and cfg.escalation_policy == "deprioritize" and \
                self._queue:
            self._preempt(st)

    def run(self, max_steps: int | None = None) -> ServingSummary:
        """Drive step() until queue and slots drain (or max_steps)."""
        steps = 0
        while self._queue or self.occupied_slots:
            if max_steps is not None and steps >= max_steps:
                break
            self.step()
            steps += 1
        return self.metrics.summary()
