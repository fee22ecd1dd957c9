"""Dry-run sweep of the port (the twin of ``repro.launch.sweep``): every
(arch x shape) cell x {single-pod, multi-pod}.

Each cell runs in a fresh subprocess (``python -m
repro_torch.launch.dryrun``: its fake process group and its memory end
with it, and a pathological cell times out without killing the sweep).
Results land in ``results/dryrun_torch/<mesh>/<arch>__<shape>.json`` —
never the reference's ``results/dryrun/``; a skipped cell writes its skip
reason, a failed one its error.

    PYTHONPATH=src python -m repro_torch.launch.sweep --mesh single
    PYTHONPATH=src python -m repro_torch.launch.sweep --mesh multi
    PYTHONPATH=src python -m repro_torch.launch.sweep --report
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.configs.cells import enumerate_cells

__all__ = ["DEFAULT_OUT", "run_cell", "report", "main"]

DEFAULT_OUT = "results/dryrun_torch"


def _record(out_path: str, result: dict) -> dict:
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    return result


def run_cell(cell, mesh: str, out_dir: str, timeout: int = 3600,
             extra_args: list[str] | None = None) -> dict:
    """Run one cell on the ``mesh`` ("single" or "multi") in a subprocess
    and return its record (also written under ``out_dir/mesh/``)."""
    out_path = os.path.join(out_dir, mesh,
                            f"{cell.arch_id}__{cell.shape.name}.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    head = {"arch": cell.arch_id, "shape": cell.shape.name}
    if cell.skip:
        return _record(out_path, {**head, "skipped": cell.skip})
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", cell.arch_id, "--shape", cell.shape.name,
           "--out", out_path] + (["--multi-pod"] if mesh == "multi" else [])
    cmd += extra_args or []
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        return _record(out_path, {**head,
                                  "error": f"timeout after {timeout}s"})
    if proc.returncode != 0:
        return _record(out_path, {**head, "error": proc.stderr[-4000:],
                                  "wall_s": round(time.time() - t0, 1)})
    with open(out_path) as f:
        return json.load(f)


def report(out_dir: str) -> None:
    """A table of the results under ``out_dir``: per cell its status,
    analytic bytes a device, the three roofline terms on the H100 spec,
    the dominant one and the roofline fraction."""
    envs = set()
    for mesh in ("single", "multi"):
        d = os.path.join(out_dir, mesh)
        if not os.path.isdir(d):
            continue
        print(f"\n=== mesh: {mesh} ===")
        print(f"{'cell':42s} {'status':10s} {'mem/dev':>9s} "
              f"{'compute_s':>10s} {'memory_s':>10s} {'coll_s':>10s} "
              f"{'dominant':>10s} {'roofline%':>9s} {'trace_s':>8s}")
        for fn in sorted(os.listdir(d)):
            with open(os.path.join(d, fn)) as f:
                r = json.load(f)
            env = r.get("env", {})
            if env:
                envs.add((env.get("torch", "?"), env.get("backend", "?")))
            name = f"{r.get('arch', '?')}/{r.get('shape', '?')}"
            if "skipped" in r:
                print(f"{name:42s} {'SKIP':10s}  ({r['skipped'][:60]})")
                continue
            if "error" in r:
                print(f"{name:42s} {'ERROR':10s}  ({r['error'][-60:]!r})")
                continue
            mem = r.get("memory_analytic", {}).get("analytic_bytes", 0)
            rf = r.get("roofline", {})
            frac = rf.get("roofline_fraction")
            print(f"{name:42s} {'ok':10s} {mem / 1e9:8.1f}G "
                  f"{rf.get('compute_s', 0):10.4f} "
                  f"{rf.get('memory_s', 0):10.4f} "
                  f"{rf.get('collective_s', 0):10.4f} "
                  f"{rf.get('dominant', '?'):>10s} "
                  f"{(frac or 0) * 100:8.2f}% "
                  f"{r.get('trace_s', 0):8.1f}")
    if envs:
        print("\nproduced under: " + "; ".join(
            f"torch {v} ({b} process group)" for v, b in sorted(envs)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--only", default="",
                    help="substring filter on arch/shape")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--extra", action="append", default=[],
                    help="extra args forwarded to the dry-run")
    args = ap.parse_args(argv)

    if args.report:
        report(args.out)
        return 0

    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    failures = 0
    for mesh in meshes:
        for cell in enumerate_cells():
            if args.only and args.only not in cell.name:
                continue
            out_path = os.path.join(args.out, mesh,
                                    f"{cell.arch_id}__{cell.shape.name}.json")
            if args.skip_existing and os.path.exists(out_path):
                with open(out_path) as f:
                    prev = json.load(f)
                if "error" not in prev:
                    print(f"[skip existing] {mesh}/{cell.name}")
                    continue
            t0 = time.time()
            r = run_cell(cell, mesh, args.out, timeout=args.timeout,
                         extra_args=args.extra)
            status = ("SKIP" if "skipped" in r
                      else "ERROR" if "error" in r else "ok")
            failures += status == "ERROR"
            print(f"[{status:5s}] {mesh}/{cell.name} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    report(args.out)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
