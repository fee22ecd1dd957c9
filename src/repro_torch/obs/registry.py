"""Process-wide telemetry registry of the port: named counters, gauges and
histograms (the port's copy of ``repro.obs.registry``; the port imports
nothing of the JAX package, so it keeps its own).

One :class:`Registry` instance (:data:`REGISTRY`) is the process's metric
namespace. Modules get-or-create their instruments at import or first use —

    from repro_torch.obs import registry as obs_registry
    C = obs_registry.REGISTRY.counter(
        "serving_queue_rejections_total",
        "admissions refused by max_queue backpressure",
        labels=("modality",))
    C.inc(modality="lm")

— and every instrument shows up in ``obs.export.prometheus_text`` and in
``snapshot()`` (a JSON-safe form). ``reset`` zeroes values but keeps
registrations; ``dump_state``/``restore_state`` give a caller (a test)
write-isolation.

:class:`KeyedCounter` is the odd one out: a counter over *opaque Python
keys* (tuples holding configs and specs) with the mapping surface of a
``collections.Counter`` (``c[key] += 1``, ``c.items()``), rendered in the
exposition through :func:`key_str`. The port's ``core.plan.build_counts``
(the step and executor builds) is one.

Standard library only: ``core.plan`` imports this module at import time.
Single-writer assumption: the serving loop is single-threaded; a lock
guards registration only, not the per-sample dict updates.
"""

from __future__ import annotations

import collections
import threading
from typing import Iterable, Iterator

__all__ = ["Counter", "Gauge", "Histogram", "KeyedCounter", "Registry",
           "REGISTRY", "key_str", "DEFAULT_BUCKETS"]

#: Default histogram buckets (seconds): serving latencies from sub-ms to 10s.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


def key_str(key) -> str:
    """Deterministic-within-a-process string form of an opaque counter key.

    Primitives render as their repr; anything else (spec dataclasses) as
    ``TypeName#xxxxxxxx`` from its hash — stable within a process, which is
    all the exposition needs (cross-process joins go through snapshot()'s
    structured values, not the label text)."""
    if isinstance(key, tuple):
        return "(" + ", ".join(key_str(k) for k in key) + ")"
    if key is None or isinstance(key, (str, int, float, bool)):
        return repr(key)
    return f"{type(key).__name__}#{hash(key) & 0xFFFFFFFF:08x}"


class _Metric:
    """Shared shape of the label-tuple-valued instruments."""
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Iterable[str] = ()) -> None:
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self.values: dict[tuple[str, ...], float] = {}

    def _key(self, labels: dict) -> tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.label_names)}")
        return tuple(str(labels[n]) for n in self.label_names)

    # -- test-isolation hooks (Registry.dump_state/restore_state) -----------
    def _dump(self):
        return dict(self.values)

    def _restore(self, state) -> None:
        self.values = dict(state)

    def _clear(self) -> None:
        self.values = {}


class Counter(_Metric):
    """Monotonic counter; ``inc(amount, **labels)``."""
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        self.values[key] = self.values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self.values.get(self._key(labels), 0.0)

    def total(self) -> float:
        return sum(self.values.values())

    def labels(self, **labels) -> "_Bound":
        """Pre-bound child for hot paths: resolves the label key once."""
        return _Bound(self, self._key(labels))


class Gauge(_Metric):
    """Last-write-wins gauge; ``set(value, **labels)``."""
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self.values[self._key(labels)] = float(value)

    def value(self, **labels) -> float:
        return self.values.get(self._key(labels), float("nan"))

    def labels(self, **labels) -> "_Bound":
        return _Bound(self, self._key(labels))


class _Bound:
    """A (metric, resolved-label-key) pair — one dict write per update."""
    __slots__ = ("_m", "_k")

    def __init__(self, metric: _Metric, key: tuple[str, ...]) -> None:
        self._m, self._k = metric, key

    def inc(self, amount: float = 1.0) -> None:
        v = self._m.values
        v[self._k] = v.get(self._k, 0.0) + amount

    def set(self, value: float) -> None:
        self._m.values[self._k] = float(value)


class Histogram(_Metric):
    """Cumulative-bucket histogram; per label key a
    ``{"buckets": [n per upper bound], "sum": s, "count": n}`` record."""
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Iterable[str] = (),
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, help, labels)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"{name}: empty bucket set")
        self.values: dict[tuple[str, ...], dict] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        st = self.values.get(key)
        if st is None:
            st = self.values[key] = {"buckets": [0] * len(self.buckets),
                                     "sum": 0.0, "count": 0}
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                st["buckets"][i] += 1
        st["sum"] += float(value)
        st["count"] += 1

    def _dump(self):
        return {k: {"buckets": list(v["buckets"]), "sum": v["sum"],
                    "count": v["count"]} for k, v in self.values.items()}

    def _restore(self, state) -> None:
        self.values = {k: {"buckets": list(v["buckets"]), "sum": v["sum"],
                           "count": v["count"]} for k, v in state.items()}


class KeyedCounter:
    """Counter over opaque Python keys — mapping-compatible with a
    ``collections.Counter`` (``c[key]`` defaults to 0, ``c[key] += 1``
    writes, ``items()``/``len``/``in`` work), registered on a
    :class:`Registry` so it resets/snapshots/exposes with everything else."""
    kind = "keyed_counter"
    label_names = ("key",)

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._data: collections.Counter = collections.Counter()

    def __getitem__(self, key) -> int:
        return self._data[key]

    def __setitem__(self, key, value) -> None:
        self._data[key] = value

    def __delitem__(self, key) -> None:
        del self._data[key]

    def __contains__(self, key) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key, default=0):
        return self._data.get(key, default)

    def items(self):
        return self._data.items()

    def keys(self):
        return self._data.keys()

    def values(self):
        return self._data.values()

    def total(self) -> int:
        return sum(self._data.values())

    def _dump(self):
        return collections.Counter(self._data)

    def _restore(self, state) -> None:
        self._data = collections.Counter(state)

    def _clear(self) -> None:
        self._data = collections.Counter()


class Registry:
    """A named-metric namespace: get-or-create registration (idempotent;
    kind/label mismatches raise), plus whole-registry snapshot/reset."""

    def __init__(self) -> None:
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif type(m) is not cls:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{type(m).__name__}, not {cls.__name__}")
            elif kw.get("labels") is not None and \
                    tuple(kw["labels"]) != m.label_names:
                raise ValueError(
                    f"metric {name!r} already registered with labels "
                    f"{m.label_names}, not {tuple(kw['labels'])}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels=tuple(labels))

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels=tuple(labels))

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help,
                                   labels=tuple(labels), buckets=buckets)

    def keyed_counter(self, name: str, help: str = "") -> KeyedCounter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = KeyedCounter(name, help)
            elif not isinstance(m, KeyedCounter):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{type(m).__name__}, not KeyedCounter")
            return m

    def metrics(self) -> dict[str, object]:
        """Name -> instrument, sorted by name (a copy)."""
        with self._lock:
            return dict(sorted(self._metrics.items()))

    def value(self, name: str) -> float:
        """Sum over every label key of one counter (0.0 when absent) —
        the one-liner for before/after deltas (builds, fallbacks)."""
        m = self._metrics.get(name)
        return float(m.total()) if m is not None else 0.0

    def snapshot(self) -> dict:
        """JSON-safe view of every instrument: label keys flattened to
        ``a=b,c=d`` strings, opaque keys through :func:`key_str`."""
        out: dict[str, dict] = {}
        for name, m in self.metrics().items():
            if isinstance(m, KeyedCounter):
                vals = {key_str(k): v for k, v in m.items()}
            elif isinstance(m, Histogram):
                vals = {_flat(m.label_names, k): {"sum": v["sum"],
                                                  "count": v["count"]}
                        for k, v in m.values.items()}
            else:
                vals = {_flat(m.label_names, k): v
                        for k, v in m.values.items()}
            out[name] = {"kind": m.kind, "values": vals}
        return out

    def reset(self) -> None:
        """Zero every instrument's values; registrations survive."""
        with self._lock:
            for m in self._metrics.values():
                m._clear()

    # -- test isolation ------------------------------------------------------
    def dump_state(self) -> dict:
        with self._lock:
            return {name: m._dump() for name, m in self._metrics.items()}

    def restore_state(self, state: dict) -> None:
        """Put every instrument back to ``dump_state()``'s values;
        instruments registered after the dump are zeroed (registration
        itself is keep-forever — executors cache bound handles)."""
        with self._lock:
            for name, m in self._metrics.items():
                if name in state:
                    m._restore(state[name])
                else:
                    m._clear()


def _flat(names: tuple[str, ...], key: tuple[str, ...]) -> str:
    return ",".join(f"{n}={v}" for n, v in zip(names, key))


#: The process registry every port module registers on.
REGISTRY = Registry()
