"""The port's trace verifier (``repro_torch.obs.verify``) and roofline
table (``repro_torch.launch.roofline``) on the CPU.

The verifier is held to the reference's ``benchmarks/verify_obs.py``
(loaded by path, as the port's other tests load it): the same violations,
in the same words, on the same records — a clean server trace and a
router trace with a host killed, both written by the port's
``examples.serve_uncertainty_lm``, and each of them with one invariant of
the reference's docstring broken — and the same CLI output and exit code.
The roofline table reads a directory holding a run record of a small qwen2
cell, a skip record and an error record.
"""

import copy
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.examples import serve_uncertainty_lm
from repro_torch.launch import dryrun, roofline, sweep
from repro_torch.obs import export as t_export
from repro_torch.obs import registry as t_reg
from repro_torch.obs import trace as t_trace
from repro_torch.obs import verify

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
#: tests/test_launch.py's width-reduced qwen2 overrides.
SMALL = dict(n_layers=2, d_model=256, n_heads=16, n_kv_heads=8, head_dim=16,
             d_ff=512, vocab_size=2048)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference():
    return _load("verify_obs")


@pytest.fixture(autouse=True)
def _isolate_port_obs():
    state = t_reg.REGISTRY.dump_state()
    was_enabled = t_trace.TRACER.enabled
    try:
        yield
    finally:
        t_reg.REGISTRY.restore_state(state)
        if not was_enabled:
            t_trace.TRACER.disable()


def _example(tmp: pathlib.Path, *flags: str) -> tuple[list, str]:
    """The example's traced run: (its trace records, its exposition)."""
    trace, prom = tmp / "trace.jsonl", tmp / "metrics.prom"
    argv = ["--server", "--trace-out", str(trace), "--metrics-out",
            str(prom), "--device", "cpu", *flags]
    assert serve_uncertainty_lm.main(argv) == 0
    t_trace.TRACER.clear()
    return verify.load_jsonl(str(trace)), prom.read_text()


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """{"server": a clean one-host run, "router": three hosts, host 0
    killed mid-run, with a scan} as (records, exposition)."""
    state = t_reg.REGISTRY.dump_state()
    try:
        return {
            "server": _example(tmp_path_factory.mktemp("server")),
            "router": _example(tmp_path_factory.mktemp("router"), "--hosts",
                               "3", "--chaos", "--scan")}
    finally:
        t_reg.REGISTRY.restore_state(state)
        t_trace.TRACER.disable()


def _first(events, name=None, kind=None, rid=None) -> int:
    """The index of the first record with that name, kind and request."""
    return next(i for i, e in enumerate(events)
                if name in (None, e.get("name"))
                and kind in (None, e.get("kind"))
                and rid in (None, e.get("attrs", {}).get("req_id")))


def _rid(events):
    return next(e["attrs"]["req_id"] for e in events
                if e["name"] == "enqueue")


def _event(name, t, rid, kind="event"):
    return {"t": t, "name": name, "kind": kind, "attrs": {"req_id": rid}}


def _plant(events: list, how: str) -> list:
    """``events`` with one invariant broken (a copy)."""
    ev = copy.deepcopy(events)
    rid = _rid(ev)
    t_end = ev[-1]["t"]
    if how == "missing_field":
        del ev[3]["kind"]
    elif how == "clock_backwards":
        ev[5]["t"] = ev[4]["t"] - 1.0
    elif how == "end_not_innermost":
        i = _first(ev, kind="end")
        ev[i]["span"] = ev[i]["span"] + 10_000
    elif how == "end_with_no_span":
        ev.append({"t": t_end, "name": "stray", "kind": "end", "span": 1})
    elif how == "wrong_parent":
        i = _first(ev, kind="begin")
        ev[i]["parent"] = 99_999
    elif how == "span_never_ends":
        ev.append({"t": t_end, "name": "open", "kind": "begin",
                   "span": 99_999, "parent": None})
    elif how == "token_before_admit":
        i = _first(ev, name="enqueue", rid=rid)
        ev.insert(i + 1, _event("token", ev[i]["t"], rid))
    elif how == "duplicate_enqueue":
        i = _first(ev, name="enqueue", rid=rid)
        ev.insert(i + 1, copy.deepcopy(ev[i]))
    elif how == "admit_twice":
        i = _first(ev, name="admit", kind="begin", rid=rid)
        ev.insert(i + 1, copy.deepcopy(ev[i]) | {"span": 99_999,
                                                  "parent": ev[i]["span"]})
        ev.insert(i + 2, {"t": ev[i]["t"], "name": "admit", "kind": "end",
                          "span": 99_999})
    elif how == "preempt_queued":
        i = _first(ev, name="enqueue", rid=rid)
        ev.insert(i + 1, _event("preempt", ev[i]["t"], rid))
    elif how == "after_finish":
        ev.append(_event("token", t_end, rid))
    elif how == "never_finishes":
        del ev[_first(ev, name="finish", rid=rid)]
    elif how == "retry_without_cause":
        i = _first(ev, name="enqueue", rid=rid)
        ev.insert(i + 1, _event("retry", ev[i]["t"], rid))
    elif how == "cancel_running":
        i = _first(ev, name="token", rid=rid)
        ev.insert(i + 1, _event("cancel", ev[i]["t"], rid))
    elif how == "after_shed":
        ev += [_event("enqueue", t_end, "shed-me"),
               _event("shed", t_end, "shed-me"),
               _event("token", t_end, "shed-me")]
    else:
        raise ValueError(how)
    return ev


PLANTED = ("missing_field", "clock_backwards", "end_not_innermost",
           "end_with_no_span", "wrong_parent", "span_never_ends",
           "token_before_admit", "duplicate_enqueue", "admit_twice",
           "preempt_queued", "after_finish", "never_finishes",
           "retry_without_cause", "cancel_running", "after_shed")


@pytest.mark.parametrize("run", ("server", "router"))
def test_clean_traces_pass_both_verifiers(traces, reference, run):
    events, prom = traces[run]
    names = {e["name"] for e in events}
    assert {"enqueue", "admit", "token", "finish"} <= names
    if run == "router":
        assert {"host_death", "retry", "remesh", "chunk"} <= names
    assert verify.verify_trace_events(events) == \
        reference.verify_trace_events(events) == []
    assert verify.verify_metrics_text(prom) == \
        reference.verify_metrics_text(prom) == []


@pytest.mark.parametrize("how", PLANTED)
@pytest.mark.parametrize("run", ("server", "router"))
def test_planted_violation_found_as_the_reference_finds_it(
        traces, reference, run, how):
    events = _plant(traces[run][0], how)
    got = verify.verify_trace_events(events)
    assert got, how
    assert got == reference.verify_trace_events(events)


def test_metrics_missing_a_counter_or_malformed(reference):
    reg = t_reg.Registry()
    reg.counter("serving_requests_total", "work items enqueued").inc(3)
    reg.counter("serving_decode_steps_total", "decode steps").inc()
    full = t_export.prometheus_text(reg)
    cut = "\n".join(ln for ln in full.splitlines()
                    if "serving_decode_steps_total" not in ln)
    for text, want in ((full, []),
                       (cut, ["exposition is missing "
                              "serving_decode_steps_total"]),
                       ("", ["exposition is empty",
                             "exposition is missing serving_requests_total",
                             "exposition is missing "
                             "serving_decode_steps_total"])):
        assert verify.verify_metrics_text(text) == want
        assert reference.verify_metrics_text(text) == want
    bad = full + "\nnot a sample line {\n"
    got = verify.verify_metrics_text(bad)
    assert len(got) == 1 and got[0].startswith("exposition does not parse")
    assert got == reference.verify_metrics_text(bad)


def _cli(module: str, args: list[str]) -> tuple[int, str]:
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    return out.returncode, out.stdout


def test_cli_output_and_exit_codes_match_the_reference(traces, tmp_path):
    """``python -m repro_torch.obs.verify`` against ``python -m
    benchmarks.verify_obs`` on a clean trace with its exposition (exit
    0) and a trace with a request that never finishes (exit 1): the same
    exit code and the same printed lines."""
    events, prom = traces["router"]
    clean, bad, metrics = (tmp_path / "clean.jsonl", tmp_path / "bad.jsonl",
                           tmp_path / "m.prom")
    for path, evs in ((clean, events), (bad, _plant(events,
                                                   "never_finishes"))):
        path.write_text("".join(json.dumps(e) + "\n" for e in evs))
    metrics.write_text(prom)
    for args, rc in ((["--trace", str(clean), "--metrics", str(metrics)], 0),
                     (["--trace", str(bad)], 1)):
        got = _cli("repro_torch.obs.verify", args)
        assert got[0] == rc
        assert got == _cli("benchmarks.verify_obs", args)
    assert verify.main(["--trace", str(bad)]) == 1


# ---------------------------------------------------------------------------
# the roofline table
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """A results directory: single/ with a run record of the small qwen2
    ``train_4k`` cell, a skip record and an error record."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    (out / "single").mkdir()
    run = dryrun.run_cell("qwen2-1.5b", "train_4k", overrides=dict(SMALL))
    (out / "single" / "qwen2-1.5b__train_4k.json").write_text(
        json.dumps(run))
    skipped = next(c for c in sweep.enumerate_cells() if c.skip)
    sweep.run_cell(skipped, "single", str(out))
    (out / "single" / "xlstm-350m__train_4k.json").write_text(json.dumps(
        {"arch": "xlstm-350m", "shape": "train_4k",
         "error": "Traceback ...\nRuntimeError: shape is invalid"}))
    return out, run, skipped


def test_roofline_rows_and_header(results):
    out, run, skipped = results
    md = roofline.table("single", str(out), quiet=True)
    lines = md.splitlines()
    assert lines[0] == ("### Roofline — single-pod mesh (256 devices, "
                        "h100-sxm5-80gb constants)")
    assert "v5e" not in md and "MXU" not in md
    assert lines[2] == ("| cell | compute_s | memory_s | collective_s | "
                        "dominant | MODEL/HLO flops | roofline frac | "
                        "next lever |")
    rows = {ln.split(" | ")[0][2:]: ln.split(" | ") for ln in lines[4:]}
    assert len(rows) == 3
    rf = run["roofline"]
    row = rows["qwen2-1.5b/train_4k"]
    assert row[1:4] == [f"{rf['compute_s']:.4f}", f"{rf['memory_s']:.4f}",
                        f"{rf['collective_s']:.4f}"]
    assert row[4] == f"**{rf['dominant']}**"
    assert row[5] == f"{rf['useful_flops_ratio']:.2f}"
    assert row[6] == f"{rf['roofline_fraction'] * 100:.2f}%"
    assert rows[skipped.name][4] == "SKIP"
    assert skipped.skip[:70] in rows[skipped.name][7]
    assert rows["xlstm-350m/train_4k"][4] == "ERROR"
    assert "shape is invalid" in rows["xlstm-350m/train_4k"][7]


def test_roofline_numbers_are_the_reference_tables(results, monkeypatch):
    """The reference's ``bench_roofline`` over the same records prints the
    same cells, terms, dominant term, ratio and fraction; only the header
    and the lever notes name the other device."""
    out, _, _ = results
    ref = _load("bench_roofline")
    monkeypatch.setattr(ref, "RESULTS", str(out))
    want = ref.table("single", quiet=True).splitlines()
    got = roofline.table("single", str(out), quiet=True).splitlines()
    assert len(got) == len(want)
    for g, w in zip(got[2:], want[2:]):
        assert g.split(" | ")[:7] == w.split(" | ")[:7]


def test_roofline_cli(results, tmp_path):
    out, _, _ = results
    rc, text = _cli("repro_torch.launch.roofline", ["--results", str(out)])
    assert rc == 0
    assert "### Roofline — single-pod mesh" in text
    assert "multi-pod" not in text
    assert roofline.main(["--results", str(tmp_path)]) == 1
