"""Split a training step of one family into its forward + backward and its
optimizer update, on the card.

    python3 tools/probe_family_train.py ARCH LAYERS B S [--steps N]
        [--update auto|whole|blocked]

Builds ``ARCH`` at its published widths cut to ``LAYERS`` layers (bf16,
4 masks, remat "full", random weights from seed 0) with the optimizer its
published config picks (``launch.dryrun.pick_optimizer`` of
``registry.get_config(ARCH)``: Adafactor without the global clip above 40B
parameters, AdamW below), as ``chip_smoke.py``'s family training phases
do, and runs ``N`` (default 3) steps on ``lm_batch`` data of B x S
tokens: ``Model.loss`` and ``torch.autograd.grad`` timed apart from
``optimizer.update`` (host clock, each part ending in a synchronize).
Each step prints one JSON line: the loss, the two parts' seconds, the
peak memory after the backward and after the update. ``--update`` picks
Adafactor's update of a factored slice above
``optim.optimizers._CHUNK_ELEMS`` elements: ``auto`` (the default, the
port's: whole where its temporaries fit in the card's free memory, else
in blocks), ``whole`` (every slice whole: the form before the blocked
update) or ``blocked`` (every such slice in blocks).
An out-of-memory error is printed as the step's line with the memory
allocated when it was raised, not raised.

It needs one card; it imports nothing of JAX. Examples:
``arctic-480b 1 1 4096 --update whole`` (runs out of memory),
``qwen2-vl-72b 8 1 4096 --update blocked``, ``xlstm-350m 24 1 4096
--steps 2`` (the sLSTM's time loop at train_4k's sequence).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_family_train: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("layers", type=int)
    ap.add_argument("batch", type=int)
    ap.add_argument("seq", type=int)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--update", choices=("auto", "whole", "blocked"),
                    default="auto",
                    help="Adafactor's update of a large factored slice")
    ns = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.configs import registry
    from repro_torch.core import tree as tree_lib
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.launch import dryrun
    from repro_torch.models import model as lm_model
    from repro_torch.optim import OptimizerConfig, build_optimizer
    from repro_torch.optim import optimizers
    from repro_torch.train import train_state_init

    dev = torch.device("cuda", torch.cuda.current_device())
    if ns.update == "whole":
        optimizers._CHUNK_ELEMS = 1 << 62
    elif ns.update == "blocked":
        optimizers._WHOLE_BYTES = 1 << 62
    cfg = registry.get_config(ns.arch, mask_samples=4, remat="full",
                              n_layers=ns.layers)
    pick = dryrun.pick_optimizer(registry.get_config(ns.arch))
    model = lm_model.build_model(cfg)
    opt = build_optimizer(OptimizerConfig(
        name=pick.name, clip_norm=pick.clip_norm, lr=3e-4, warmup_steps=2,
        decay_steps=20))
    torch.cuda.reset_peak_memory_stats()
    state = train_state_init(model, opt, torch.Generator(dev).manual_seed(0),
                             device=dev)
    print(json.dumps({"arch": ns.arch, "layers": ns.layers,
                      "optimizer": pick.name, "update": ns.update,
                      "resident_gb": torch.cuda.memory_allocated() / 1e9,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=ns.seq,
                        global_batch=ns.batch,
                        family="audio" if cfg.family == "audio" else "dense",
                        d_model=cfg.d_model, dtype=cfg.dtype)
    params = state["params"]
    leaves = tree_lib.leaves(params)
    for step in range(ns.steps):
        batch = lm_batch(data, step, dev)
        rec = {"step": step}
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for p in leaves:
                p.requires_grad_(True)
            loss, _ = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rec.update(loss=float(loss.detach()), forward_backward_s=t1 - t0,
                       backward_peak_gb=torch.cuda.max_memory_allocated()
                       / 1e9)
            del loss
            opt.update(tree_lib.unflatten(params, grads), state["opt"],
                       params)
            del grads
            torch.cuda.synchronize()
            rec.update(optimizer_s=time.perf_counter() - t1,
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        except torch.OutOfMemoryError as err:
            rec.update(out_of_memory=str(err).split(". ")[0],
                       allocated_gb=torch.cuda.memory_allocated() / 1e9,
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            print(json.dumps(rec), flush=True)
            return 0
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
