"""Serving metrics: request latency, throughput, slot occupancy, queue depth
(the port's twin of ``repro.serving.metrics``).

The server (serving/server.py) drives one collector per run: request
lifecycle marks (enqueue -> admit -> first token -> finish) plus one
occupancy/queue sample per engine step. ``summary()`` folds them into the
numbers a capacity planner wants: tokens/s, p50/p99 request latency,
time-to-first-token, mean slot occupancy and peak queue depth.

Work items carry a modality label ("lm" or "voxel") so a mixed pool rolls
up into one stream with per-modality splits: ``total_tokens``/``tokens_per_s``
count LM emissions only, while voxel-chunk progress lands in
``total_voxels``/``voxels_per_s`` (``on_token(units=...)`` with the chunk's
valid voxel count). Occupancy keeps one total gauge (so single-modality
numbers are unchanged) plus a voxel-slot sample per step.

Timestamps come from an injectable clock so tests and trace replays can run
on virtual time; the default is ``obs.trace.default_clock`` (monotonic),
the one sanctioned serving clock — nothing in this package calls ``time.*``
directly.

The collector is double-entry: every lifecycle mark ALSO drives the
``obs.registry`` instruments (``serving_requests_total{modality}``, ...),
so the Prometheus exposition and :meth:`summary` can never disagree on
totals — one method updates both. Note the registry is process-global by
default, so its totals accumulate across collectors; pass a fresh
``Registry`` to isolate (tests do).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from repro_torch.obs import registry as obs_registry
from repro_torch.obs import trace as obs_trace

__all__ = ["RequestTimeline", "ServingSummary", "MetricsCollector"]


@dataclasses.dataclass
class RequestTimeline:
    """Lifecycle marks of one request (seconds on the collector's clock)."""
    req_id: int
    enqueue_t: float
    admit_t: float | None = None
    first_token_t: float | None = None
    finish_t: float | None = None
    tokens_out: int = 0
    escalated: bool = False
    modality: str = "lm"

    @property
    def latency(self) -> float | None:
        """enqueue -> finish (what the client waits)."""
        if self.finish_t is None:
            return None
        return self.finish_t - self.enqueue_t

    @property
    def queue_wait(self) -> float | None:
        return None if self.admit_t is None else self.admit_t - self.enqueue_t

    @property
    def ttft(self) -> float | None:
        """Time to first token (enqueue -> first emitted token)."""
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.enqueue_t


@dataclasses.dataclass(frozen=True)
class ServingSummary:
    requests: int
    completed: int
    escalated: int
    total_tokens: int
    wall_s: float
    tokens_per_s: float
    latency_p50_s: float
    latency_p99_s: float
    ttft_p50_s: float
    queue_wait_p50_s: float
    mean_slot_occupancy: float     # occupied / max_slots, averaged over steps
    peak_queue_depth: int
    decode_steps: int
    # -- per-modality split (all-LM runs leave the voxel side at zero/NaN) --
    lm_requests: int = 0
    voxel_requests: int = 0
    total_voxels: int = 0
    voxels_per_s: float = float("nan")
    mean_voxel_occupancy: float = float("nan")   # voxel slots / max_slots

    def format(self) -> str:
        # Empty aggregates render as "n/a", never as a perfect-looking 0.0:
        # a run where nothing completed must not report "p99 0.0 ms".
        out = (
            f"requests          {self.completed}/{self.requests} completed"
            f" ({self.escalated} escalated)\n"
            f"throughput        {_fmt(self.tokens_per_s, width=9)} tok/s"
            f"  ({self.total_tokens} tokens / {self.wall_s:.3f} s,"
            f" {self.decode_steps} decode steps)\n"
            f"request latency   p50 {_fmt(self.latency_p50_s, 1e3, 8)} ms"
            f"   p99 {_fmt(self.latency_p99_s, 1e3, 8)} ms\n"
            f"first token       p50 {_fmt(self.ttft_p50_s, 1e3, 8)} ms"
            f"   queue wait p50 {_fmt(self.queue_wait_p50_s, 1e3)} ms\n"
            f"slot occupancy    {_fmt(self.mean_slot_occupancy, 100, 5)} %"
            f"   peak queue depth {self.peak_queue_depth}"
        )
        if self.voxel_requests:
            out += (
                f"\nvoxel scans       {self.voxel_requests} scans"
                f" ({self.lm_requests} lm requests alongside),"
                f" {self.total_voxels} voxels\n"
                f"voxel throughput  {_fmt(self.voxels_per_s, width=9)} vox/s"
                f"   voxel occupancy "
                f"{_fmt(self.mean_voxel_occupancy, 100, 5)} %"
            )
        return out


def _fmt(v: float, scale: float = 1.0, width: int = 0, prec: int = 1) -> str:
    """Fixed-point with an honest gap: NaN (no data) renders as n/a."""
    return f"{'n/a':>{width}}" if math.isnan(v) \
        else f"{v * scale:{width}.{prec}f}"


def _pct(values: list[float], q: float) -> float:
    """Percentile; NaN (not a flattering 0.0) when nothing was observed."""
    return float(np.percentile(np.asarray(values), q)) if values \
        else float("nan")


class MetricsCollector:
    """Accumulates request timelines + per-step gauge samples, mirroring
    every mark onto ``obs.registry`` instruments (same numbers, two views:
    ``summary()`` for humans, the exposition for scrapers)."""

    def __init__(self, max_slots: int,
                 clock: Callable[[], float] | None = None,
                 registry: obs_registry.Registry | None = None) -> None:
        self.max_slots = max_slots
        self.clock = obs_trace.default_clock if clock is None else clock
        self.registry = obs_registry.REGISTRY if registry is None else registry
        reg = self.registry
        self._c_requests = reg.counter(
            "serving_requests_total", "work items enqueued",
            labels=("modality",))
        self._c_emissions = reg.counter(
            "serving_emissions_total",
            "units emitted (LM tokens / valid voxels)", labels=("modality",))
        self._c_finished = reg.counter(
            "serving_finished_total", "work items finished",
            labels=("modality",))
        self._c_escalated = reg.counter(
            "serving_escalated_total", "finished work items that escalated",
            labels=("modality",))
        self._c_steps = reg.counter(
            "serving_decode_steps_total", "pool decode steps executed")
        self._g_queue = reg.gauge(
            "serving_queue_depth", "queued work items at last step")
        self._g_occupied = reg.gauge(
            "serving_occupied_slots", "occupied slots at last step")
        self._g_voxel = reg.gauge(
            "serving_voxel_occupied_slots",
            "slots held by voxel chunks at last step")
        self._h_latency = reg.histogram(
            "serving_request_latency_seconds",
            "enqueue->finish latency", labels=("modality",))
        self.timelines: dict[int, RequestTimeline] = {}
        self.occupancy_samples: list[int] = []
        self.voxel_occupancy_samples: list[int] = []
        self.queue_depth_samples: list[int] = []
        self.decode_steps = 0
        self._start: float | None = None
        self._end: float | None = None

    # ---- lifecycle marks ---------------------------------------------------
    def on_enqueue(self, req_id: int, modality: str = "lm") -> None:
        t = self.clock()
        if self._start is None:
            self._start = t
        self.timelines[req_id] = RequestTimeline(req_id, enqueue_t=t,
                                                 modality=modality)
        self._c_requests.inc(modality=modality)

    def on_admit(self, req_id: int) -> None:
        self.timelines[req_id].admit_t = self.clock()

    def on_first_token(self, req_id: int) -> None:
        """Mark first-token availability (at prefill argmax, which is when
        the token is computed — one pool decode step before it is emitted
        and counted by on_token)."""
        tl = self.timelines[req_id]
        if tl.first_token_t is None:
            tl.first_token_t = self.clock()

    def on_token(self, req_id: int, units: int = 1) -> None:
        """One emission: an LM token, or a voxel chunk (units = its valid
        voxel count)."""
        t = self._end = self.clock()   # wall extends through every emission,
        tl = self.timelines[req_id]    # so truncated runs aren't inflated
        tl.tokens_out += units
        if tl.first_token_t is None:
            tl.first_token_t = t
        self._c_emissions.inc(units, modality=tl.modality)

    def on_finish(self, req_id: int, escalated: bool = False) -> None:
        tl = self.timelines[req_id]
        tl.finish_t = self._end = self.clock()
        tl.escalated = escalated
        self._c_finished.inc(modality=tl.modality)
        if escalated:
            self._c_escalated.inc(modality=tl.modality)
        if tl.latency is not None:
            self._h_latency.observe(tl.latency, modality=tl.modality)

    # ---- per-step gauges ---------------------------------------------------
    def on_step(self, occupied_slots: int, queue_depth: int,
                voxel_occupied: int = 0) -> None:
        self.decode_steps += 1
        self.occupancy_samples.append(occupied_slots)
        self.voxel_occupancy_samples.append(voxel_occupied)
        self.queue_depth_samples.append(queue_depth)
        self._c_steps.inc()
        self._g_occupied.set(occupied_slots)
        self._g_voxel.set(voxel_occupied)
        self._g_queue.set(queue_depth)

    # ---- rollup ------------------------------------------------------------
    def summary(self) -> ServingSummary:
        tls = list(self.timelines.values())
        done = [t for t in tls if t.finish_t is not None]
        lat = [t.latency for t in done]
        ttft = [t.ttft for t in done if t.ttft is not None]
        qw = [t.queue_wait for t in done if t.queue_wait is not None]
        lm = [t for t in tls if t.modality == "lm"]
        vox = [t for t in tls if t.modality == "voxel"]
        total_tokens = sum(t.tokens_out for t in lm)
        total_voxels = sum(t.tokens_out for t in vox)
        wall = (self._end - self._start) \
            if self._start is not None and self._end is not None else 0.0
        occ = (float(np.mean(self.occupancy_samples)) / self.max_slots
               if self.occupancy_samples else float("nan"))
        vocc = (float(np.mean(self.voxel_occupancy_samples)) / self.max_slots
                if self.voxel_occupancy_samples else float("nan"))
        return ServingSummary(
            requests=len(tls),
            completed=len(done),
            escalated=sum(t.escalated for t in done),
            total_tokens=total_tokens,
            wall_s=wall,
            tokens_per_s=total_tokens / wall if wall > 0 else float("nan"),
            latency_p50_s=_pct(lat, 50),
            latency_p99_s=_pct(lat, 99),
            ttft_p50_s=_pct(ttft, 50),
            queue_wait_p50_s=_pct(qw, 50),
            mean_slot_occupancy=occ,
            peak_queue_depth=max(self.queue_depth_samples, default=0),
            decode_steps=self.decode_steps,
            lm_requests=len(lm),
            voxel_requests=len(vox),
            total_voxels=total_voxels,
            voxels_per_s=total_voxels / wall if wall > 0 and vox
            else float("nan"),
            mean_voxel_occupancy=vocc,
        )
