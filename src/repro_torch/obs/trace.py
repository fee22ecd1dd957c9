"""Lightweight nested span tracing with a bounded ring buffer (the port's
copy of ``repro.obs.trace``).

A :class:`Tracer` records point events (``event("token", req_id=3, ...)``)
and nested spans (``with tracer.span("admit", req_id=3): ...``) into a
bounded in-process ``deque`` — one dict append per record, no I/O on the
hot path — and exports the whole ring as JSONL (``export_jsonl``). Span
begin/end records carry a span id and the enclosing span's id, so offline
tooling (the repository's ``benchmarks/verify_obs.py``) can rebuild the
nesting and each request's full lifecycle from the log alone.

The module-level :data:`TRACER` is the process tracer, **disabled by
default**: the cached step closures in ``serving.server`` are
process-global and cannot hold a per-server tracer, so they emit here and
``ServerConfig(trace=True)`` turns it on. When disabled, ``event()``
returns after one attribute check and ``span()`` yields immediately — and
tracing never reads a tensor, so tokens and moments are bitwise the same
with tracing on or off.

The clock is injectable and monotonic. :data:`default_clock` is the ONE
sanctioned wall-clock source for the serving path — serving modules take
it as their injectable default instead of calling ``time.monotonic``
directly.

Standard library only (the same import-order constraint as
``obs.registry``).
"""

from __future__ import annotations

import collections
import contextlib
import json
import time
from typing import Callable

__all__ = ["Tracer", "TRACER", "span", "event", "default_clock",
           "ManualClock"]

#: The sanctioned serving clock (monotonic; immune to wall-clock steps).
default_clock: Callable[[], float] = time.monotonic


class ManualClock:
    """Deterministic, manually-advanced monotonic clock — a drop-in for
    :data:`default_clock` wherever a clock is injectable (the tracer,
    serving metrics). Reading it never moves it; ``advance()`` moves
    virtual time forward, so timings replay identically regardless of host
    speed."""

    def __init__(self, start: float = 0.0) -> None:
        self._t = float(start)

    def __call__(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        """Move virtual time forward ``dt`` seconds (monotonic — negative
        steps are rejected); returns the new time."""
        if dt < 0:
            raise ValueError(f"ManualClock cannot go backwards (dt={dt})")
        self._t += float(dt)
        return self._t


def _json_default(o):
    return str(o)


class Tracer:
    """Bounded ring of trace records. Records are plain dicts:

    ``{"t": float, "name": str, "kind": "event"|"begin"|"end",
       "span": id-or-None, ["parent": id-or-None,] "attrs": {...}}``

    ``span`` on an ``"event"`` record is the *enclosing* span's id (None at
    top level); on ``"begin"``/``"end"`` it is the span's own id, with the
    enclosing id in ``"parent"``."""

    def __init__(self, capacity: int = 65536,
                 clock: Callable[[], float] = default_clock,
                 enabled: bool = False) -> None:
        self._ring: collections.deque = collections.deque(
            maxlen=int(capacity))
        self._clock = clock
        self._enabled = bool(enabled)
        self._next_id = 0
        self._stack: list[int] = []

    # -- switches ------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def configure(self, *, capacity: int | None = None,
                  clock: Callable[[], float] | None = None) -> None:
        """Resize/re-clock the tracer; clears the ring (records from two
        clocks or two capacities don't mix)."""
        if capacity is not None:
            self._ring = collections.deque(maxlen=int(capacity))
        if clock is not None:
            self._clock = clock
        self.clear()

    def clear(self) -> None:
        self._ring.clear()
        self._stack.clear()
        self._next_id = 0

    # -- recording -----------------------------------------------------------
    def event(self, name: str, **attrs) -> None:
        """One point event (one append; no-op when disabled)."""
        if not self._enabled:
            return
        self._ring.append({
            "t": self._clock(), "name": name, "kind": "event",
            "span": self._stack[-1] if self._stack else None,
            "attrs": attrs})

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Nested span context: a ``begin`` record on entry, ``end`` on
        exit; point events inside carry this span's id."""
        if not self._enabled:
            yield
            return
        self._next_id += 1
        sid = self._next_id
        self._ring.append({
            "t": self._clock(), "name": name, "kind": "begin", "span": sid,
            "parent": self._stack[-1] if self._stack else None,
            "attrs": attrs})
        self._stack.append(sid)
        try:
            yield
        finally:
            self._stack.pop()
            self._ring.append({"t": self._clock(), "name": name,
                               "kind": "end", "span": sid, "attrs": {}})

    # -- export --------------------------------------------------------------
    def events(self) -> list[dict]:
        return list(self._ring)

    def to_jsonl(self) -> str:
        if not self._ring:
            return ""
        return "\n".join(json.dumps(e, default=_json_default)
                         for e in self._ring) + "\n"

    def export_jsonl(self, path) -> int:
        """Write the ring as JSONL (one record per line); returns the
        record count."""
        with open(path, "w") as f:
            f.write(self.to_jsonl())
        return len(self._ring)


#: Process tracer (disabled by default — ``ServerConfig(trace=True)``
#: enables it; a caller sizes it via ``configure(capacity=...)``).
TRACER = Tracer()


def span(name: str, **attrs):
    return TRACER.span(name, **attrs)


def event(name: str, **attrs) -> None:
    TRACER.event(name, **attrs)
