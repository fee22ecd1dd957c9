"""Rate and tail arithmetic over all requests, and the per-layer readers
over a fake window."""

import types

import numpy as np
import pytest

from portbench import harness
from portbench.drivers import lm_server
from portbench.run import reader


def _rec(due, times):
    return types.SimpleNamespace(due=due, times=list(times))


def _steady(n_req=40, step=0.05, tokens=20):
    recs = []
    for i in range(n_req):
        due = i * 0.5
        recs.append(_rec(due, [due + 0.1 + step * k for k in range(tokens)]))
    return recs


def test_rates_and_tails_over_all_requests():
    recs = _steady()
    e2e, ttft, itl, tokens = lm_server.window_metrics(recs, 0.0, 30.0)
    assert len(ttft) == 40 and tokens == 40 * 20
    assert e2e["decode_tokens_per_s"] == pytest.approx(800 / 30.0)
    assert e2e["ttft_p95_ms"] == pytest.approx(100.0)
    assert e2e["itl_p95_ms"] == pytest.approx(50.0)


def test_stall_moves_ttft_and_itl():
    base, *_ = lm_server.window_metrics(_steady(), 0.0, 30.0)
    stalled = _steady()
    for r in stalled[10:14]:          # a 1 s stall before their first token
        r.times = [t + 1.0 for t in r.times]
    for r in stalled[20:25]:          # and a 0.6 s gap inside others
        r.times = r.times[:5] + [t + 0.6 for t in r.times[5:]]
    got, *_ = lm_server.window_metrics(stalled, 0.0, 30.0)
    assert got["ttft_p95_ms"] > base["ttft_p95_ms"] + 500
    assert got["itl_p95_ms"] == pytest.approx(base["itl_p95_ms"])
    many = _steady()
    for r in many:                    # two long gaps in every request
        r.times = (r.times[:5] + [t + 0.6 for t in r.times[5:10]]
                   + [t + 1.2 for t in r.times[10:]])
    got, *_ = lm_server.window_metrics(many, 0.0, 30.0)
    assert got["itl_p95_ms"] > 600


def test_only_the_window_counts():
    recs = _steady()
    e2e, ttft, _, tokens = lm_server.window_metrics(recs, 5.0, 10.0)
    first = [r.times[0] for r in recs]
    assert len(ttft) == sum(5.0 < t <= 10.0 for t in first)
    assert tokens == sum(5.0 < t <= 10.0 for r in recs for t in r.times)


def _trace(ops, ranges=(), window=1.0):
    return harness.DeviceTrace(window, list(ops), list(ranges))


def test_busy_idle_and_breakdown():
    t = _trace([("k1", 0.0, 0.2), ("k2", 0.1, 0.3), ("k1", 0.5, 0.6)],
               [("portbench.step", 0.0, 0.7), ("serving.step", 0.3, 0.55)])
    assert t.busy_s() == pytest.approx(0.4)
    assert reader("idle_share.decode")(types.SimpleNamespace(trace=t)) \
        == pytest.approx(60.0)
    assert t.top_ops()[0] == ["k1", pytest.approx(0.3)]
    gaps = dict(t.idle_gaps())
    assert gaps["serving.step"] == pytest.approx(0.2)
    assert gaps["host.outside_ranges"] == pytest.approx(0.4)


def _spans():
    ev = []
    for i, (due, start, end) in enumerate([(1.0, 1.1, 1.2), (2.0, 2.5, 2.6),
                                           (3.0, 3.05, 3.45)]):
        ev.append({"t": start, "name": "admit", "kind": "begin", "span": i,
                   "attrs": {"req_id": i, "kind": "lm"}})
        ev.append({"t": end, "name": "admit", "kind": "end", "span": i,
                   "attrs": {}})
    return ev


def test_span_readers():
    tally = {"spans": _spans(), "dues": {0: 1.0, 1: 2.0, 2: 3.0},
             "t0": 0.0, "t1": 10.0}
    ctx = types.SimpleNamespace(tally=tally)
    assert reader("queue_wait_ms_p95.chat")(ctx) == pytest.approx(
        1e3 * float(np.percentile([0.1, 0.5, 0.05], 95)))
    assert reader("admit_ms_mean.chat")(ctx) == pytest.approx(
        1e3 * (0.1 + 0.1 + 0.4) / 3)
    tally["t0"] = 2.2
    assert reader("admit_ms_mean.chat")(ctx) == pytest.approx(250.0)
