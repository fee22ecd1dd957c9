"""Pieces every driver and reader shares: the host clock, host ranges for
the profiler's breakdown, tails, and the profiler trace reduced to device
operations and host ranges."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from pathlib import Path

import numpy as np

__all__ = ["ROOT", "clock", "Marks", "load_json", "HostRanges", "pct",
           "DeviceTrace", "reduce_trace"]

ROOT = Path(__file__).resolve().parent

#: The benchmark's clock: monotonic, and the one the program's tracer
#: stamps its spans with (``obs.trace.default_clock``), so arrival times
#: and span times compare directly.
clock = time.monotonic

#: Host ranges the harness opens start with this prefix; the program's own
#: ``obs.profile.annotate`` ranges start with "serving.".
RANGE_PREFIXES = ("portbench.", "serving.")


class Marks:
    """Set-up's parts: ``mark(name)`` books the seconds since the last
    mark (the device synchronized first) under ``name``."""

    def __init__(self, parts: dict, device) -> None:
        self.parts, self.device = parts, device
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.parts[name] = now - self.t
        self.t = now


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class HostRanges:
    """``range(name)``: a ``torch.profiler.record_function`` around a call
    into the program in a traced run, nothing otherwise."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled

    def range(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(f"portbench.{name}")


def pct(values, q: float) -> float | None:
    """The q-th percentile (linear interpolation) of all ``values``; None
    when there are none."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


@dataclasses.dataclass
class DeviceTrace:
    """A traced window: device operations (kernels, copies, sets) as
    (name, start_s, end_s) clipped to the window, and the host ranges as
    (name, start_s, end_s), all relative to the window's start."""
    window_s: float
    ops: list
    ranges: list

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        total, end = 0.0, 0.0
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            s = max(s, end)
            if e > s:
                total += e - s
                end = e
        return total

    def op_seconds(self, needle: str) -> float:
        """Device seconds of operations whose name contains ``needle``."""
        return sum(e - s for n, s, e in self.ops if needle in n)

    def top_ops(self, k: int = 10) -> list:
        by: dict[str, float] = {}
        for n, s, e in self.ops:
            by[n[:120]] = by.get(n[:120], 0.0) + (e - s)
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:k]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle device time summed by the innermost host range open at the
        middle of each gap ("host.outside_ranges" where none is)."""
        gaps, end = [], 0.0
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.window_s > end:
            gaps.append((end, self.window_s))
        ranges = sorted(self.ranges, key=lambda r: r[1])
        by: dict[str, float] = {}
        i, active = 0, []
        for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = 0.5 * (s + e)
            while i < len(ranges) and ranges[i][1] <= mid:
                active.append(ranges[i])
                i += 1
            active = [r for r in active if r[2] >= mid]
            name = (min(active, key=lambda r: r[2] - r[1])[0] if active
                    else "host.outside_ranges")
            by[name] = by.get(name, 0.0) + (e - s)
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:k]


def _kineto_events(prof):
    """(name, is_device, start_ns, end_ns) of every event the profiler
    kept, from kineto's own list (no event tree is built)."""
    import torch
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == torch.autograd.DeviceType.CUDA
        start = e.start_ns()
        out.append((e.name(), dev, start, start + e.duration_ns()))
    return out


def reduce_trace(prof, window_range: str) -> DeviceTrace:
    """The profiler's events inside the host range named ``window_range``
    (the measured window). GPU-side copies of host annotations are not
    device work and are left out."""
    events = _kineto_events(prof)
    win = [(s, e) for n, dev, s, e in events if not dev and n == window_range]
    if not win:
        raise RuntimeError(f"traced run has no {window_range!r} range")
    w0, w1 = win[0]
    ops, ranges = [], []
    for n, dev, s, e in events:
        if n.startswith(RANGE_PREFIXES):
            if not dev and n != window_range and e > w0 and s < w1:
                ranges.append((n, (max(s, w0) - w0) * 1e-9,
                               (min(e, w1) - w0) * 1e-9))
            continue
        if dev and e > w0 and s < w1:
            ops.append((n, (max(s, w0) - w0) * 1e-9,
                        (min(e, w1) - w0) * 1e-9))
    return DeviceTrace((w1 - w0) * 1e-9, ops, ranges)
