"""The knee of an open-loop LM cell: the highest offered rate the server
sustains without a growing backlog, found once by a sweep on the card.

    python3 portbench/sweep.py --workload lm-chat-open --seconds 30 \
        --rates 2,3,4,5,6

For each rate one set-up and one window at that rate (the cell's traffic
otherwise unchanged); one JSON line a rate: requests offered and refused,
decode tokens/s, the TTFT and ITL tails, and the admission queue's mean
depth over the first and the last quarter of the window's steps. The cell
files then carry their rates as numbers.
"""

from __future__ import annotations

import argparse
import copy
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    base = run.load("workloads", args.workload)
    config = run.load("configs", base["config"])
    run_seconds = json.loads((ROOT / "BENCHMARK.json").read_text()
                             )["run_seconds"]
    driver = importlib.import_module(f"portbench.drivers.{base['driver']}")
    dev = torch.device("cuda", 0)
    for rate in (float(r) for r in args.rates.split(",")):
        cell = copy.deepcopy(base)
        cell["traffic"]["rate_per_s"] = rate
        with torch.no_grad():
            sess = driver.setup(cell, config, args.seed, dev, False,
                                run_seconds)
            out = sess.run(args.seconds)
        q = sess.window["queue"]
        k = max(1, len(q) // 4)
        print(json.dumps({"rate_per_s": rate, **out,
                          "queue_first": sum(q[:k]) / k,
                          "queue_last": sum(q[-k:]) / k,
                          "steps": len(q),
                          "requests_first_answered":
                              len(sess.window["ttft"])}), flush=True)
        sess.release()
        del sess
    return 0


if __name__ == "__main__":
    sys.exit(main())
