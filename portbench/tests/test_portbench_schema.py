"""BENCHMARK.json against the benchmark's contract, the files it names,
and the schema of a run's last line."""

import json
import re
import subprocess
import sys

import pytest

from portbench import run
from portbench.tests import smoke

BENCH = smoke.BENCH
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs_and_cells():
    cfgs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["why"]) <= 200
        data = json.loads((run.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert sorted(data["reduced"]) == sorted(c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size")) or "hidden" in k
                       or "heads" in k for k in c["reduced"])
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        cell = run.load("workloads", w["traffic"])
        assert cell["name"] == w["name"] and cell["config"] == w["config"]
        assert w["config"] in cfgs
        used.add(w["config"])
        assert cell["limits"], f"{w['name']} has no limits"
    assert used == set(cfgs)


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert (run.HERE / "layer_metrics" / f"{m['name']}.py").exists()
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", cells)
        if m["name"].endswith("roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        e, layer = run.cell_metrics(BENCH, cell)
        assert "setup_s" in {m["name"] for m in e} and len(e) >= 2
        assert layer, f"{cell} reports no per-layer metric"


def _keys_in_order(result):
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"


def test_last_line_schema_untraced():
    result, numbers = smoke.run_small("ivim-slab-stream", seconds=2.5)
    _keys_in_order(result)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"voxels_per_s", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"} and name in numbers
    json.dumps(result)


def test_last_line_schema_traced():
    result, _ = smoke.run_small("lm-chat-open", seconds=2.5, trace=True)
    _keys_in_order(result)
    assert set(result["metrics"]) <= {m["name"] for m in BENCH["per_layer"]
                                      if "lm-chat-open" in m["workloads"]}
    assert {"busy_s", "window_s"} <= set(result["device"])
    bd = result["breakdown"]
    assert set(bd) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in bd.values())
    json.dumps(result)


@pytest.mark.parametrize("argv", [["--workload", "ivim-slab-stream"],
                                  ["--workload", "no-such-cell"]])
def test_no_card_no_result(argv):
    out = subprocess.run(
        [sys.executable, str(run.HERE / "run.py"), *argv, "--seed",
         "3000000000", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=str(run.ROOT))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
