"""Small shapes of the benchmark's cells for the CPU tests: the cell and
configuration files with their widths, slabs and traffic cut down, the
LM configuration in fp32."""

from __future__ import annotations

import json

import torch

from portbench import run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")


def lm_config() -> dict:
    c = run.load("configs", "qwen2-7b-m4")
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             num_hidden_layers=2, intermediate_size=128, vocab_size=512,
             torch_dtype="float32")
    return c


def configs() -> dict:
    return {"uivim-dense104-m8": run.load("configs", "uivim-dense104-m8"),
            "qwen2-7b-m4": lm_config()}


def cell(name: str) -> dict:
    c = run.load("workloads", name)
    tr = c["traffic"]
    if "server" in c:
        c["server"].update(max_slots=4, max_prompt_len=24, max_new_tokens=12)
        tr["prompt"].update(min=8, max=24, median=12)
        tr["output"].update(min=4, max=12, median=8)
        if tr["loop"] == "closed":
            tr.update(clients=4, block=8, cycles=64)
        else:
            tr.update(rate_per_s=20.0, prime_s=0.3)
    else:
        tr.update(slab=[8, 8, 4], distinct=2, check_voxels=16)
    return c


def run_small(name: str, seed: int = 987654321012, seconds: float = 1.0,
              trace: bool = False, control: bool = False):
    """One run of ``name`` at the small shapes, on one intra-op thread: at
    these widths more threads only contend with the other test workers,
    and a run slowed that way finishes too few requests to judge."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run.run_cell(BENCH, name, seed, seconds, trace, device=CPU,
                            control=control, cell=cell(name),
                            configs=configs())
    finally:
        torch.set_num_threads(threads)
