"""Roofline table of the port's dry-run records (the twin of the
reference's ``benchmarks/bench_roofline.py``).

Reads ``results/dryrun_torch/{single,multi}/*.json`` (what
``launch.sweep`` writes; another directory with ``--results``) and prints
one markdown table a mesh: per (arch x shape) cell the three roofline
terms, the dominant one, MODEL/HLO FLOPs (``useful_flops_ratio``), the
roofline fraction and the lever that would move the dominant term. A
skipped cell and a failed cell each get their own row, with the skip
reason or the error's end (its last line, where the reference shows the
first characters of a traceback). The numbers are the records' own
(``launch.dryrun.analyze`` priced them on ``core.latency_model.H100``);
the header names the device and the device count the records carry.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--results DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

__all__ = ["RESULTS", "MESHES", "load", "table", "main"]

RESULTS = "results/dryrun_torch"
#: mesh directory -> its nominal device count (the production meshes)
MESHES = {"single": 256, "multi": 512}

_MOVE_NOTES = {
    "collective": ("shrink FSDP all-gathers (overlap with compute, 2D-shard "
                   "or cache gathered layers) / cut attention partial "
                   "all-reduces via head-TP; NVLink bytes"),
    "memory": ("raise arithmetic intensity: bigger per-device batch, fuse "
               "elementwise chains into hand-written kernels, bf16 "
               "residuals end to end"),
    "compute": ("already tensor-core-bound: only kernel-level tiling wins "
                "remain (wgmma, TMA)"),
}


def load(mesh: str, results: str = RESULTS) -> list[dict]:
    """The records under ``results/mesh/``, by file name."""
    d = os.path.join(results, mesh)
    if not os.path.isdir(d):
        return []
    rows = []
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".json"):
            with open(os.path.join(d, fn)) as f:
                rows.append(json.load(f))
    return rows


def _header(mesh: str, rows: list[dict]) -> str:
    run = [r for r in rows if "roofline" in r]
    devices = sorted({r["roofline"]["device"] for r in run})
    counts = sorted({r["n_chips"] for r in run}) or [MESHES[mesh]]
    what = (", ".join(devices) + " constants" if devices
            else "no run record")
    return (f"### Roofline — {mesh}-pod mesh "
            f"({' / '.join(str(c) for c in counts)} devices, {what})")


def _fmt(x, spec: str, unit: str = "") -> str:
    return "—" if x is None else format(x, spec) + unit


def table(mesh: str = "single", results: str = RESULTS,
          quiet: bool = False) -> str:
    """The markdown table of one mesh's records (printed unless
    ``quiet``)."""
    rows = load(mesh, results)
    lines = [
        _header(mesh, rows),
        "",
        "| cell | compute_s | memory_s | collective_s | dominant | "
        "MODEL/HLO flops | roofline frac | next lever |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        name = f"{r.get('arch')}/{r.get('shape')}"
        if "skipped" in r:
            lines.append(f"| {name} | — | — | — | SKIP | — | — | "
                         f"{r['skipped'][:70]} |")
            continue
        if "error" in r:
            lines.append(f"| {name} | — | — | — | ERROR | — | — | "
                         f"{r['error'][-60:]!r} |")
            continue
        rf = r["roofline"]
        frac = rf.get("roofline_fraction")
        lines.append(
            f"| {name} | {rf['compute_s']:.4f} | {rf['memory_s']:.4f} | "
            f"{rf['collective_s']:.4f} | **{rf['dominant']}** | "
            f"{_fmt(rf.get('useful_flops_ratio'), '.2f')} | "
            f"{_fmt(None if frac is None else frac * 100, '.2f', '%')} | "
            f"{_MOVE_NOTES[rf['dominant']]} |")
    out = "\n".join(lines)
    if not quiet:
        print(out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--results", default=RESULTS,
                    help="directory holding single/ and multi/ records")
    args = ap.parse_args(argv)
    found = False
    for mesh in MESHES:
        if load(mesh, args.results):
            found = True
            table(mesh, args.results)
            print()
    if not found:
        print(f"no dry-run records under {args.results}/{{single,multi}}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
