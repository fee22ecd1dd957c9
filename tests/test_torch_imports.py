"""The PyTorch port stands alone: it imports neither ``jax`` nor anything of
the JAX package, and its entry points run on the card unless told the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import device as device_lib
from repro_torch.configs import registry
from repro_torch.data import LMDataConfig, lm_batch
from repro_torch.optim import OptimizerConfig, build_optimizer
from repro_torch.train import TrainConfig, Trainer, train_state_init
from repro_torch.core import plan as plan_lib
from repro_torch.core import transform
from repro_torch.ivim import evaluate as ivim_eval
from repro_torch.ivim import model as ivim_model
from repro_torch.ivim import train as ivim_train
from repro_torch.models import model as lm_model
from repro_torch.models import transformer
from repro_torch.serving import engine, router, server

SRC = Path(__file__).resolve().parents[1] / "src"


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [k for k in sys.modules if k in ('jax', 'repro') or "
        "k.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.distributed.compression' in names, names\n"
        "for n in ('models.rglru', 'models.moe', 'models.xlstm',\n"
        "          'kernels.rglru_scan.ops',\n"
        "          'kernels.flash_attention.ops', 'kernels.moments.ops',\n"
        "          'kernels.moments.ref', 'core.transform',\n"
        "          'core.latency_model', 'ivim.train', 'ivim.evaluate',\n"
        "          'serving.router', 'serving.faults',\n"
        "          'distributed.straggler', 'distributed.elastic',\n"
        "          'obs.crosscheck', 'data.pipeline', 'optim.optimizers',\n"
        "          'train.trainer', 'distributed.checkpoint', 'core.tree',\n"
        "          'distributed.sharding', 'distributed.pipeline',\n"
        "          'launch', 'launch.mesh', 'launch.dryrun', 'launch.sweep',\n"
        "          'configs.cells'):\n"
        "    assert 'repro_torch.' + n in names, names\n"
        "assert len(names) >= 60, names\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(SRC),
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 60


def _tiny_plan():
    cfg = ivim_model.IvimConfig(n_masks=2)
    model = ivim_model.init(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    return ivim_model.pack_for_serving(model), torch.rand(5, cfg.width)


def test_entry_points_raise_without_cuda(monkeypatch):
    """device=None means the card: with no card every entry point raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan, x = _tiny_plan()
    small = ivim_model.init(ivim_model.IvimConfig(n_masks=2),
                            torch.Generator().manual_seed(0), device="cpu")
    cfg = registry.smoke_config("qwen2-1.5b", n_layers=1)
    lm = lm_model.build_model(cfg)
    toks = torch.zeros((1, 3), dtype=torch.int32)
    calls = [
        lambda: engine.generate(lm, {}, toks),
        lambda: engine.serve_uncertain(lm, {}, toks),
        lambda: server.step_fns(lm),
        lambda: router.ServingRouter(lm, {}),
        lambda: plan_lib.compile_decode_step(cfg),
        lambda: lm.init(torch.Generator().manual_seed(0)),
        lambda: lm.forward({}, {"tokens": toks}),
        lambda: transformer.forward(registry.smoke_config("hubert-xlarge"),
                                    {}, {"embeds": torch.zeros((1, 3, 64))}),
        lambda: engine.predict_volume(plan, x[None]),
        lambda: engine.predict_packed(plan, x),
        lambda: engine.plan_chunk_runner(plan),
        lambda: plan_lib.execute(plan, x),
        lambda: plan_lib.execute_fused(plan, x, moments=True),
        lambda: ivim_model.init(ivim_model.IvimConfig(),
                                torch.Generator().manual_seed(0)),
        lambda: ivim_train.train(ivim_model.IvimConfig(),
                                 ivim_train.TrainConfig(steps=1)),
        lambda: ivim_eval.evaluate_snr_sweep(small, n_voxels=8),
        lambda: transform.convert(transform.MlpSpec((3, 4, 2), (1,)), 2,
                                  2.0, torch.Generator().manual_seed(0)),
        lambda: device_lib.resolve(None),
        lambda: lm_batch(LMDataConfig(vocab_size=8, seq_len=4,
                                      global_batch=2), 0),
        lambda: train_state_init(lm, build_optimizer(OptimizerConfig()),
                                 torch.Generator().manual_seed(0)),
        lambda: Trainer(lm, build_optimizer(OptimizerConfig()),
                        TrainConfig(), LMDataConfig(vocab_size=8, seq_len=4,
                                                    global_batch=2)),
        lambda: device_lib.resolve("cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert device_lib.resolve("cpu") == torch.device("cpu")


def test_cpu_only_when_asked():
    plan, x = _tiny_plan()
    mean, std = engine.predict_volume(plan, x[None], chunk=2, device="cpu")
    assert mean.device.type == "cpu" and mean.shape == (1, 5, 4)


def test_int8_precision_raises():
    """Only an unknown precision raises: int8 serves in the port now (its
    parity with the reference is tests/test_torch_quantized.py)."""
    with pytest.raises(ValueError, match="unknown weight precision"):
        plan_lib.Precision("bf16")
    assert plan_lib.Precision().weights == "fp32"
    plan, x = _tiny_plan()
    q = plan.with_precision(plan_lib.Precision("int8"))
    mean, std = engine.predict_volume(q, x[None], chunk=2, device="cpu")
    assert mean.shape == (1, 5, 4) and bool(torch.isfinite(std).all())
