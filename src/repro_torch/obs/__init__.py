"""Observability of the port: span tracing, the telemetry registry, its
exposition, guarded profiler annotations and the modeled-vs-measured
cross-check (the port's copy of ``repro.obs``).

* ``obs.trace``    — nested spans + point events into a bounded ring,
  JSONL export; the process :data:`~repro_torch.obs.trace.TRACER` is
  disabled by default and switched on by ``ServerConfig(trace=True)``.
* ``obs.registry`` — named counters/gauges/histograms (+ the opaque-key
  ``KeyedCounter`` behind ``core.plan.build_counts``) on the process
  :data:`~repro_torch.obs.registry.REGISTRY`; ``obs.export`` renders it as
  Prometheus text and parses it back.
* ``obs.profile``  — ``torch.profiler.record_function`` ranges, off unless
  ``REPRO_PROFILE`` or ``enable()`` asks.
* ``obs.crosscheck`` — joins measured wall time against the analytic
  traffic models into a ``model_fidelity`` block (import it explicitly or
  reach it as ``obs.crosscheck``).

``core.plan`` imports ``obs.registry`` at module import time, so these
eager imports stay standard-library only (``obs.profile`` imports torch
only when a range is opened); ``crosscheck``, which prices on
``core.latency_model``, is exposed lazily as the reference exposes it.
"""

from repro_torch.obs import export, profile, registry, trace  # noqa: F401

__all__ = ["export", "profile", "registry", "trace", "crosscheck"]


def __getattr__(name):
    if name == "crosscheck":
        import importlib
        return importlib.import_module("repro_torch.obs.crosscheck")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
