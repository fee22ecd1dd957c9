"""Optional ``torch.profiler`` annotations, guarded to zero overhead.

``annotate("serving.step")`` returns a ``torch.profiler.record_function``
when profiling is enabled (``REPRO_PROFILE=1`` in the environment, or
``enable()``), else a ``nullcontext`` — so the serving hot loop can stay
annotated permanently. An annotation names a host-side range in a profiler
trace and computes nothing: turning it on builds no step and changes no
result (the port's ``core.plan.build_counts`` stays flat; tests hold it).
"""

from __future__ import annotations

import contextlib
import os

__all__ = ["enabled", "enable", "disable", "annotate"]

_state = {"enabled": os.environ.get("REPRO_PROFILE", "") not in ("", "0")}


def enabled() -> bool:
    return _state["enabled"]


def enable() -> None:
    _state["enabled"] = True


def disable() -> None:
    _state["enabled"] = False


def annotate(name: str):
    """Context manager: a profiler ``record_function`` range when enabled,
    else a no-op (torch imported lazily so the guard costs one dict
    read)."""
    if not _state["enabled"]:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)
