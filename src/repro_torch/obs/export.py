"""Prometheus-style text exposition of an ``obs.registry`` Registry, the
matching parser (the golden-file test round-trips through it), and
host/run provenance (the port's copy of ``repro.obs.export``).

Format (text exposition 0.0.4 conventions):

    # HELP serving_requests_total work items enqueued
    # TYPE serving_requests_total counter
    serving_requests_total{modality="lm"} 16
    serving_queue_depth NaN

NaN gauges render literally as ``NaN`` (an honest "no data", matching
``serving.metrics``'s NaN-not-zero convention); histograms emit cumulative
``_bucket{le=...}`` lines plus ``_sum``/``_count``; KeyedCounter keys render
through ``registry.key_str`` under a single ``key`` label.
"""

from __future__ import annotations

import math
import re
import socket
import subprocess
from pathlib import Path

from repro_torch.obs import registry as registry_lib

__all__ = ["prometheus_text", "parse_exposition", "host_provenance"]


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


def _fmt_value(v: float) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(names: tuple[str, ...], values: tuple[str, ...],
               extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def prometheus_text(registry: registry_lib.Registry | None = None) -> str:
    """Render every instrument of ``registry`` (default: the process
    registry) as Prometheus text exposition."""
    reg = registry_lib.REGISTRY if registry is None else registry
    lines: list[str] = []
    for name, m in reg.metrics().items():
        if m.help:
            lines.append(f"# HELP {name} {_escape(m.help)}")
        kind = "counter" if m.kind == "keyed_counter" else m.kind
        lines.append(f"# TYPE {name} {kind}")
        if m.kind == "keyed_counter":
            for k, v in sorted(m.items(),
                               key=lambda kv: registry_lib.key_str(kv[0])):
                lines.append(
                    f'{name}{{key="{_escape(registry_lib.key_str(k))}"}}'
                    f" {_fmt_value(v)}")
        elif m.kind == "histogram":
            for key, st in sorted(m.values.items()):
                cum = 0
                for ub, n in zip(m.buckets, st["buckets"]):
                    cum = n
                    lines.append(
                        f"{name}_bucket"
                        f"{_label_str(m.label_names, key, (('le', _fmt_value(ub)),))}"
                        f" {cum}")
                lines.append(
                    f"{name}_bucket"
                    f"{_label_str(m.label_names, key, (('le', '+Inf'),))}"
                    f" {st['count']}")
                lines.append(f"{name}_sum{_label_str(m.label_names, key)}"
                             f" {_fmt_value(st['sum'])}")
                lines.append(f"{name}_count{_label_str(m.label_names, key)}"
                             f" {st['count']}")
        else:
            for key, v in sorted(m.values.items()):
                lines.append(f"{name}{_label_str(m.label_names, key)}"
                             f" {_fmt_value(v)}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    # Single pass: sequential str.replace would corrupt r"\\n"
    # (backslash + n) into a newline.
    return re.sub(r"\\(.)",
                  lambda m: "\n" if m.group(1) == "n" else m.group(1), v)


def parse_exposition(text: str) -> dict:
    """Parse exposition text back into
    ``{(name, ((label, value), ...)): float}``. Raises ValueError on any
    malformed sample line — a verifier relies on the loudness."""
    out: dict[tuple[str, tuple[tuple[str, str], ...]], float] = {}
    for i, ln in enumerate(text.splitlines(), 1):
        if not ln.strip() or ln.startswith("#"):
            continue
        m = _SAMPLE_RE.match(ln)
        if m is None:
            raise ValueError(f"exposition line {i} malformed: {ln!r}")
        name, labels, value = m.group(1), m.group(2), m.group(3)
        pairs: tuple[tuple[str, str], ...] = ()
        if labels:
            matched = _LABEL_RE.findall(labels)
            rebuilt = ",".join(f'{k}="{v}"' for k, v in matched)
            if rebuilt != labels:
                raise ValueError(f"exposition line {i} bad labels: {ln!r}")
            pairs = tuple((k, _unescape(v)) for k, v in matched)
        try:
            out[(name, pairs)] = float(value)
        except ValueError:
            raise ValueError(f"exposition line {i} bad value: {ln!r}")
    return out


def host_provenance() -> dict:
    """Host + revision stamp for measurement records: git SHA (None outside
    a work tree) and hostname."""
    try:
        p = subprocess.run(["git", "rev-parse", "HEAD"],
                           cwd=Path(__file__).parent, capture_output=True,
                           text=True, timeout=10)
        sha = p.stdout.strip() if p.returncode == 0 else None
    except OSError:
        sha = None
    return {"git_sha": sha, "hostname": socket.gethostname()}
