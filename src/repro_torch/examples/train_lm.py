"""End-to-end LM training: a small decoder of any assigned family,
trained for a few hundred steps with the full production stack —
Masksembles-FFN, AdamW + cosine schedule, grad accumulation, atomic
checkpoints with auto-resume, straggler monitoring.

    python -m repro_torch.examples.train_lm --steps 200 [--device cpu]
    python -m repro_torch.examples.train_lm --steps 200 --d-model 512 \
        --layers 8   # ~100M params

Kill it mid-run and re-launch: it resumes from the last committed
checkpoint with the same data (stateless seeded pipeline). On the card,
``--arch recurrentgemma-2b`` trains through the RG-LRU scan kernel,
forward and backward.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import device as device_lib
from repro_torch.configs import registry
from repro_torch.core import tree as tree_lib
from repro_torch.data import LMDataConfig
from repro_torch.models.model import build_model
from repro_torch.optim import OptimizerConfig, build_optimizer
from repro_torch.train import TrainConfig, Trainer

__all__ = ["lm_config", "run", "main"]


def lm_config(arch: str, d_model: int = 128, layers: int = 4):
    """``smoke_config`` at the example's widths: head width 32, a head per
    32 of width (at least 4), half as many KV heads, an FFN 4x wide, a
    512-token vocabulary, fp32."""
    heads = max(4, d_model // 32)
    return registry.smoke_config(
        arch, d_model=d_model, n_layers=layers, n_heads=heads,
        n_kv_heads=max(1, heads // 2), head_dim=32,
        d_ff=0 if registry.get_config(arch).d_ff == 0 else 4 * d_model,
        vocab_size=512, dtype=torch.float32)


def run(arch: str = "qwen2-1.5b", steps: int = 200, d_model: int = 128,
        layers: int = 4, seq: int = 64, batch: int = 16,
        grad_accum: int = 2, ckpt_dir: str | None = None, device=None,
        on_step=None) -> dict:
    """Train on ``device`` (None -> the card), resuming from the newest
    checkpoint under ``<ckpt_dir>_<arch>_<parameter count>``. Returns the
    config, the parameter count, the checkpoint directory, the final state
    and the history of the steps this run took."""
    dev = device_lib.resolve(device)
    cfg = lm_config(arch, d_model, layers)
    model = build_model(cfg)
    n_params = sum(t.numel() for t in tree_lib.leaves(model.param_specs()))
    # checkpoints are shape-checked on restore; key the directory by the
    # config so changing flags doesn't collide with an old run's
    if ckpt_dir is None:
        ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_lm_ckpt")
    ckpt_dir = f"{ckpt_dir}_{arch}_{n_params}"
    optimizer = build_optimizer(OptimizerConfig(
        lr=1e-3, warmup_steps=20, decay_steps=steps))
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                        global_batch=batch)
    trainer = Trainer(model, optimizer,
                      TrainConfig(steps=steps, grad_accum=grad_accum,
                                  checkpoint_dir=ckpt_dir,
                                  checkpoint_every=50), data, device=dev)
    state, history = trainer.run(on_step=on_step)
    return {"cfg": cfg, "n_params": n_params, "ckpt_dir": ckpt_dir,
            "state": state, "history": history}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b",
                    choices=list(registry.ARCH_IDS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--grad-accum", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory prefix (default: "
                         "repro_lm_ckpt in the temporary directory)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    cfg = lm_config(args.arch, args.d_model, args.layers)
    n_params = sum(t.numel() for t in tree_lib.leaves(
        build_model(cfg).param_specs()))
    print(f"arch={args.arch} family={cfg.family} params={n_params/1e6:.1f}M "
          f"masksembles N={cfg.mask_samples}")

    def on_step(rec):
        if rec["step"] % 20 == 0 or rec["straggler"] != "ok":
            print(f"step {rec['step']:5d}  loss {rec['loss']:.4f}  "
                  f"{rec['time_s']*1e3:6.1f} ms  [{rec['straggler']}]")

    r = run(args.arch, args.steps, args.d_model, args.layers, args.seq,
            args.batch, args.grad_accum, args.ckpt_dir, args.device, on_step)
    hist = r["history"]
    if hist:
        print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; "
              f"checkpoints in {r['ckpt_dir']}")
    else:
        print(f"done: nothing left to train (step {args.steps} is "
              f"checkpointed in {r['ckpt_dir']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
