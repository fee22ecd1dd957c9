"""Readings that set a cell's limits: the program's numbers and the
control's over many seeds, in one process.

    python3 portbench/control.py --workload <cell> --seconds 5 \
        --seeds 11,12,13

For each seed it makes one run as ``run.py`` would (set-up, a window of
``--seconds``, the program's state freed) and then judges what the window
produced twice: against the plain fp32 reference (the program's numbers),
and with the control put in the program's place, the reference computed
one precision step below the configuration's (fp8 e4m3 products for the
bf16 LM, TF32 products for the fp32 IVIM chain). One JSON line a seed.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        result, numbers = run.run_cell(bench, args.workload, seed,
                                       args.seconds, False, t_start=t,
                                       control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"],
                          "metrics": {k: v["value"] for k, v in
                                      result["metrics"].items()},
                          "numbers": numbers,
                          "memory_peak_bytes":
                              result["device"]["memory_peak_bytes"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
