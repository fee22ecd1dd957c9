"""Offline verifier for the serving observability artifacts (the port's
copy of the reference's ``benchmarks/verify_obs.py``).

    PYTHONPATH=src python -m repro_torch.obs.verify --trace trace.jsonl \
                                                    --metrics metrics.prom

Replays a JSONL span/event log (``obs.trace.Tracer.export_jsonl``: a
traced server or router run, ``examples.serve_uncertainty_lm
--trace-out``) into a per-request lifecycle state machine and checks the
invariants the tracer promises:

* every record carries ``t``/``name``/``kind`` and timestamps are
  non-decreasing (one monotonic clock);
* span ``begin``/``end`` records nest strictly (the tracer is
  single-threaded context managers — an ``end`` must close the innermost
  open span);
* request lifecycles are consistent: ``enqueue`` -> ``admit`` ->
  (``token``|``chunk``|``escalate``)* -> (``preempt`` -> ``admit`` ...)* ->
  ``finish`` — no token before admission, nothing after finish, and every
  enqueued request finishes;
* router failover lifecycles are consistent: a ``retry`` event may only
  appear inside an open ``host_death`` or ``straggler_drain`` span (work
  is never resubmitted without a recorded cause), ``cancel`` withdraws
  only queued work, a retried request re-enters through a fresh
  ``enqueue`` (the re-admit leg of the host-death -> retry -> re-admit
  lifecycle), and ``shed`` is terminal — every request ends finished or
  shed;
* the ``--metrics`` exposition parses (``obs.export.parse_exposition``)
  and contains the serving counters.

Exit code 0 when every check holds, 1 with one ``OBS VIOLATION:`` line
each otherwise. Importable: :func:`verify_trace_events` takes the records
of an in-process run. Standard library only, as the rest of ``obs``.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import export as obs_export

__all__ = ["verify_trace_events", "load_jsonl", "verify_metrics_text",
           "main"]

#: request-scoped event names that need an admitted (running) request
_NEEDS_RUNNING = ("token", "chunk", "escalate")
#: the router spans that may carry a ``retry`` (its recorded cause)
_RETRY_CAUSES = ("host_death", "straggler_drain")
#: the counters every serving exposition holds
_SERVING_COUNTERS = ("serving_requests_total", "serving_decode_steps_total")


def verify_trace_events(events: list[dict]) -> list[str]:
    """Replay trace records; returns a list of human-readable violations
    (empty = consistent)."""
    errors: list[str] = []
    last_t = None
    span_stack: list[int] = []
    span_names: list[str] = []     # open-span names (failover context)
    state: dict[object, str] = {}

    def err(i: int, msg: str) -> None:
        errors.append(f"record {i}: {msg}")

    for i, ev in enumerate(events):
        for field in ("t", "name", "kind"):
            if field not in ev:
                err(i, f"missing field {field!r}: {ev}")
        t, name, kind = ev.get("t"), ev.get("name"), ev.get("kind")
        if isinstance(t, (int, float)):
            if last_t is not None and t < last_t:
                err(i, f"timestamp went backwards ({t} < {last_t})")
            last_t = t
        if kind == "begin":
            span_stack.append(ev.get("span"))
            span_names.append(name)
            if ev.get("parent") != (span_stack[-2] if len(span_stack) > 1
                                    else None):
                err(i, f"span {ev.get('span')} parent "
                       f"{ev.get('parent')} != enclosing span")
        elif kind == "end":
            if not span_stack:
                err(i, f"end of span {ev.get('span')} with no open span")
            else:
                if span_stack[-1] != ev.get("span"):
                    err(i, f"end of span {ev.get('span')} but innermost "
                           f"open span is {span_stack[-1]}")
                span_stack.pop()
                span_names.pop()

        rid = ev.get("attrs", {}).get("req_id")
        if rid is None:
            continue
        cur = state.get(rid)
        if cur in ("finished", "shed"):
            err(i, f"request {rid}: {name!r} after {cur}")
        elif name == "enqueue":
            # a fresh admission, or the re-admit leg of router failover
            if cur is not None and cur != "retrying":
                err(i, f"request {rid}: duplicate enqueue (state {cur})")
            state[rid] = "queued"
        elif name == "admit" and kind == "begin":
            if cur != "queued":
                err(i, f"request {rid}: admit from state {cur}")
            state[rid] = "running"
        elif name in _NEEDS_RUNNING:
            if cur != "running":
                err(i, f"request {rid}: {name!r} in state {cur} "
                       f"(no emission before admission)")
        elif name == "preempt":
            if cur != "running":
                err(i, f"request {rid}: preempt from state {cur}")
            state[rid] = "queued"
        elif name == "cancel":
            # the router's drain hook withdraws QUEUED work only
            if cur != "queued":
                err(i, f"request {rid}: cancel from state {cur}")
            state[rid] = "retrying"
        elif name == "retry":
            # failover resubmission must carry its cause: the router only
            # emits it inside a host_death / straggler_drain span
            if not any(n in _RETRY_CAUSES for n in span_names):
                err(i, f"request {rid}: retry outside a host_death/"
                       f"straggler_drain span (open: {span_names})")
            if cur not in ("queued", "running", "retrying"):
                err(i, f"request {rid}: retry from state {cur}")
            state[rid] = "retrying"
        elif name == "shed":
            state[rid] = "shed"    # graceful degradation: terminal
        elif name == "finish":
            if cur != "running":
                err(i, f"request {rid}: finish from state {cur}")
            state[rid] = "finished"
    if span_stack:
        errors.append(f"{len(span_stack)} span(s) never ended: "
                      f"{span_stack}")
    for rid, cur in sorted(state.items(), key=str):
        if cur not in ("finished", "shed"):
            errors.append(f"request {rid}: trace ends in state {cur!r}, "
                          f"not finished")
    return errors


def load_jsonl(path: str) -> list[dict]:
    """The records of a JSONL log, blank lines skipped."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def verify_metrics_text(text: str) -> list[str]:
    """Parse an exposition dump; returns violations (empty = good)."""
    try:
        samples = obs_export.parse_exposition(text)
    except ValueError as e:
        return [f"exposition does not parse: {e}"]
    errors: list[str] = []
    if not samples:
        errors.append("exposition is empty")
    names = {name for name, _ in samples}
    for want in _SERVING_COUNTERS:
        if want not in names:
            errors.append(f"exposition is missing {want}")
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace", required=True,
                    help="JSONL span/event log (a traced run's "
                         "--trace-out)")
    ap.add_argument("--metrics", default=None,
                    help="Prometheus text exposition (obs.export."
                         "prometheus_text)")
    args = ap.parse_args(argv)

    events = load_jsonl(args.trace)
    errors = verify_trace_events(events)
    if args.metrics:
        with open(args.metrics) as f:
            errors += verify_metrics_text(f.read())
    for e in errors:
        print(f"OBS VIOLATION: {e}")
    if errors:
        return 1
    print(f"obs verify: {len(events)} trace records consistent"
          + ("" if not args.metrics else ", exposition parses"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
