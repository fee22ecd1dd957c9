"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name: ``workloads/<cell>.json`` names
its configuration (``configs/<config>.json``), its driver
(``drivers/<driver>.py``), its traffic and the limits of its check; the
metrics it reports are those ``BENCHMARK.json`` lists for it, each
per-layer metric read by ``layer_metrics/<metric>.py``. Set-up (kernel
build on a checkout's first run, weights, inputs, warm-up) ends when the
window opens; ``--trace 1`` runs the window under ``torch.profiler`` and
reports the per-layer metrics instead of the end-to-end ones. After the
window the program's state is freed and the plain reference judges what
the window produced; each number compared is printed beside its limit, as
the last lines on standard error and under ``checks``, the last key of the
result line on standard output.

The run fails, printing no result, without a CUDA card (or with fewer than
the cell asks for), when the program is missing, and when JAX, flax or the
JAX package is loaded in the process once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

HERE = Path(__file__).resolve().parent

#: Top-level module names no run may hold: JAX and the JAX package the
#: port was made from (``repro``; the port is ``repro_torch``).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """The cell's end-to-end and per-layer metrics in BENCHMARK.json: those
    whose ``workloads`` name it, and an unlisted per-layer metric wherever
    the cell reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def reader(name: str):
    """``layer_metrics/<name>.py``'s ``read(ctx)``."""
    path = HERE / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device_info(torch, device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device=None, t_start: float | None = None,
             control: bool = False, cell: dict | None = None,
             configs: dict | None = None) -> tuple[dict, dict]:
    """One run; returns (result line, the check's numbers). ``cell`` and
    ``configs`` replace the files of those names (the tests' small
    shapes)."""
    import torch
    from portbench import harness
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cell or load("workloads", cell_name)
    configs = configs or {cell["config"]: load("configs", cell["config"])}
    device = torch.device("cuda", 0) if device is None else device
    driver = importlib.import_module(f"portbench.drivers.{cell['driver']}")
    with torch.no_grad():
        session = driver.setup(cell, configs[cell["config"]], seed, device,
                               trace, bench["run_seconds"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_start
        prof = None
        if trace:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                *([torch.profiler.ProfilerActivity.CUDA]
                  if device.type == "cuda" else [])])
            prof.start()
        window = session.run(seconds)
        if prof is not None:
            prof.stop()
        dev = device_info(torch, device)
        e2e_defs, layer_defs = cell_metrics(bench, cell_name)
        metrics = {}
        extra = {}
        if trace:
            dtrace = harness.reduce_trace(prof, "portbench.window")
            del prof
            ctx = types.SimpleNamespace(trace=dtrace, tally=session.tally(),
                                        cell=cell, configs=configs)
            for m in layer_defs:
                v = reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            dev["busy_s"] = dtrace.busy_s()
            dev["window_s"] = dtrace.window_s
            extra["breakdown"] = {"device_ops": dtrace.top_ops(),
                                  "idle_gaps": dtrace.idle_gaps()}
            from portbench.counts import peaks
            extra["peaks"] = {"bf16_flops": peaks.BF16_FLOPS,
                              "tf32x3_flops": peaks.TF32X3_FLOPS,
                              "hbm_bytes_per_s": peaks.HBM_BYTES_PER_S,
                              "card": peaks.power_limit()}
        else:
            values = {**window["e2e"], "setup_s": setup_s}
            for m in e2e_defs:
                if m["name"] not in values:
                    raise RuntimeError(f"{cell_name} produced no "
                                       f"{m['name']}")
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        setup_parts = dict(getattr(session, "setup_parts", {}))
        session.release()
        numbers = session.check(control=control)
        del session
        gc.collect()
    limits = cell.get("limits", {})
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in numbers.items() if k in limits}
    counted = {k: v for k, v in numbers.items() if k not in limits}
    missing = sorted(set(limits) - set(numbers))
    correct = (not missing and bool(checks)
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values())
               and all(v > 0 for k, v in counted.items()
                       if k.endswith("_checked")))
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics,
              "device": dev, **extra, "setup_parts": setup_parts,
              "counted": counted,
              "checks": checks}
    return result, numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        cell = next((w for w in bench["workloads"]
                     if w["name"] == args.workload), None)
        if cell is None:
            raise SystemExit(f"no workload {args.workload!r} in "
                             f"BENCHMARK.json")
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            print(f"needs {cell['chips']} CUDA card(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 1
        result, _ = run_cell(bench, args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START)
        # after the window and the check, before any result is printed
        found = forbidden_modules()
        if found:
            raise RuntimeError(f"forbidden modules loaded: {found}")
    except Exception:       # the run's boundary: report, print no result
        traceback.print_exc()
        return 1
    for k, v in result["setup_parts"].items():
        print(f"setup_part {k} {v!r} s", file=sys.stderr)
    for k, v in result["counted"].items():
        print(f"counted {k} {v}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
