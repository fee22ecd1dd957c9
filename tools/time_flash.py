"""Time the flash_attention kernel on the card at ``chip_smoke.py``'s flash
shapes, so that two trees can be compared within one machine.

    python3 tools/time_flash.py [--reps 50] [--label NAME]

It times whichever ``repro_torch`` is first on ``PYTHONPATH`` (the kernels
build into that tree's ``build/``). To compare a parent commit with a
change, unpack the parent (``git archive``) into a directory the checkout
ignores and run, in one command on one card, parent, change, change,
parent::

    PYTHONPATH=build/parent/src python3 tools/time_flash.py --label parent
    PYTHONPATH=src python3 tools/time_flash.py --label change

The cases are ``chip_smoke.py``'s own tables, ``HY_FLASH_CASES`` and
``BB_FLASH_CASES`` (``[hy_kernel]`` and ``[bb_kernel]``), read from the
``chip_smoke.py`` beside this tool, inputs from ``torch.randn`` with seed 4
(a case's own generator, so every case sees the same data in every tree).
A case the tree's wrapper refuses prints ``refused``. One ``[time_flash]``
line a case: ``ms`` from CUDA events around ``--reps`` back-to-back calls
after 3 warm-ups (the host's launch path included), and ``device_ms``, the
kernel's own time from ``torch.profiler`` ("not measured" where the trace
kept fewer kernel events than calls). The last line names the card and its
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its tables only; it imports no torch)


def _device_ms(fn, reps: int):
    import torch
    prof = torch.profiler
    fn()
    torch.cuda.synchronize()
    with prof.profile(activities=[prof.ProfilerActivity.CPU,
                                  prof.ProfilerActivity.CUDA]) as tr:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in tr.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if len(spans) < reps or not sum(spans):
        return "not measured"
    return sum(spans) / reps / 1e3


def _events_ms(fn, reps: int) -> float:
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--label", default="tree")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_flash: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels.flash_attention import ops as fa
    dev = torch.device("cuda", 0)
    for name, b, h, hkv, sq, skv, dh, dt, causal in (
            chip_smoke.HY_FLASH_CASES + chip_smoke.BB_FLASH_CASES):
        skv = sq if skv is None else skv
        gen = torch.Generator(dev).manual_seed(4)
        q, k, v = (torch.randn((b, n, s, dh), generator=gen, device=dev)
                   .to(getattr(torch, dt))
                   for n, s in ((h, sq), (hkv, skv), (hkv, skv)))

        def call(q=q, k=k, v=v, causal=causal):
            return fa.flash_attention(q, k, v, causal=causal)

        rec = {"label": args.label, "case": name,
               "dims": [b, h, hkv, sq, skv, dh], "dtype": dt,
               "causal": causal}
        try:
            call()
        except ValueError as err:
            rec["refused"] = str(err)
        else:
            rec["ms"] = _events_ms(call, args.reps)
            rec["device_ms"] = _device_ms(call, args.reps)
        print("[time_flash] " + json.dumps(rec), flush=True)
        del q, k, v
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[time_flash] card={card.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
