"""The port's sharding rules and activation hints against the reference,
on the CPU, with no process group.

Spec parity: one subprocess runs the reference on 8 host devices and dumps
``tuple(NamedSharding.spec)`` of every leaf of ``param_shardings`` (the
smoke configs' train states under AdamW and Adafactor, parameters
included), ``batch_shardings`` and ``cache_shardings``, on meshes (2, 4),
(4, 2) and (2, 2, 2) with "pod"; the port's rules on the same shapes (its
``meta`` stand-ins, and a ``{name: size}`` mesh) must give equal tuples,
leaf for leaf. ``resolve_spec`` is held to cases written out from the
reference's ``constrain`` (``src/repro/models/layers.py:46-62``).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import tree as tree_lib
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import layers
from repro_torch.models.model import build_model
from repro_torch.optim import OptimizerConfig, build_optimizer
from repro_torch.train import train_state_specs

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FAMILIES = ("qwen2-1.5b", "recurrentgemma-2b", "phi3.5-moe-42b-a6.6b",
            "xlstm-350m")
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
OPTIMIZERS = ("adamw", "adafactor")
#: batches: the data ranks divide B 8 (positions [3, B, S] shard dim 1),
#: not B 3; scalars replicate
BATCHES = {"b8": {"tokens": (8, 16), "labels": (8, 16),
                  "positions": (3, 8, 16), "step": ()},
           "b3": {"tokens": (3, 16), "labels": (3, 16)}}
CACHE = (8, 16)                          # batch, max_seq

_DUMP = """
import json, sys
import jax, jax.numpy as jnp
from repro import compat
from repro.configs import registry
from repro.distributed import sharding
from repro.models import build_model, transformer
from repro.optim import OptimizerConfig, build_optimizer
from repro.train import train_state_specs

FAMILIES, MESHES, OPTIMIZERS, BATCHES, CACHE = json.loads(sys.argv[1])

def path_str(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)

def specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {path_str(p): s.spec for p, s in flat}

def norm(spec):
    return [list(a) if isinstance(a, tuple) else a for a in tuple(spec)]

out = {}
for name, (shape, axes) in MESHES.items():
    mesh = compat.make_mesh(tuple(shape), tuple(axes))
    for arch in FAMILIES:
        cfg = registry.smoke_config(arch)
        model = build_model(cfg)
        for opt in OPTIMIZERS:
            st = train_state_specs(
                model, build_optimizer(OptimizerConfig(name=opt)))
            out[f"{name}/{arch}/{opt}"] = {
                k: norm(v) for k, v in
                specs(sharding.param_shardings(mesh, st)).items()}
        caches = transformer.cache_specs(cfg, *CACHE)
        out[f"{name}/{arch}/cache"] = {
            k: norm(v) for k, v in
            specs(sharding.cache_shardings(mesh, caches)).items()}
    for bname, batch in BATCHES.items():
        tree = {k: jax.ShapeDtypeStruct(tuple(v), jnp.int32)
                for k, v in batch.items()}
        out[f"{name}/{bname}/batch"] = {
            k: norm(v) for k, v in
            specs(sharding.batch_shardings(mesh, tree)).items()}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_specs():
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    args = json.dumps([FAMILIES, MESHES, OPTIMIZERS, BATCHES, CACHE])
    out = subprocess.run([sys.executable, "-c", _DUMP, args], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port_specs(shardings) -> dict:
    return {"/".join(str(k) for k in path):
            json.loads(json.dumps(s.spec))
            for path, s in tree_lib.flatten_with_path(shardings)}


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _mesh(name) -> dict:
    shape, axes = MESHES[name]
    return dict(zip(axes, shape))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_param_specs_equal_reference(reference_specs, mesh, arch, opt):
    model = build_model(registry.smoke_config(arch))
    state = train_state_specs(model,
                              build_optimizer(OptimizerConfig(name=opt)))
    got = _port_specs(sharding.param_shardings(_mesh(mesh), state))
    want = reference_specs[f"{mesh}/{arch}/{opt}"]
    assert got == want
    # the rules shard something: 2-D TP + FSDP on every weight matrix
    assert any("model" in json.dumps(s) for s in got.values())


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_specs_equal_reference(reference_specs, mesh, arch):
    cfg = registry.smoke_config(arch)
    caches = [{b: {name: _meta(shape, dtype)
                   for name, (shape, dtype) in leaves.items()}
               for b, leaves in seg.items()}
              for seg in build_model(cfg).cache_specs(*CACHE)]
    got = _port_specs(sharding.cache_shardings(_mesh(mesh), caches))
    assert got == reference_specs[f"{mesh}/{arch}/cache"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("batch", BATCHES)
def test_batch_specs_equal_reference(reference_specs, mesh, batch):
    tree = {k: _meta(v) for k, v in BATCHES[batch].items()}
    got = _port_specs(sharding.batch_shardings(_mesh(mesh), tree))
    assert got == reference_specs[f"{mesh}/{batch}/batch"]


# ---------------------------------------------------------------------------
# resolve_spec, to_placements, the hints without a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,shape,mesh,want", [
    # "batch" is ("pod", "data") as available: one name alone
    (("batch", None), (8, 3), {"data": 2, "model": 4}, ("data", None)),
    (("batch", None, "model"), (8, 3, 8), {"pod": 2, "data": 2, "model": 2},
     (("pod", "data"), None, "model")),
    # the batch axes' product must divide the dim
    (("batch",), (6,), {"pod": 2, "data": 2, "model": 2}, (None,)),
    (("batch",), (6,), {"data": 2, "model": 4}, ("data",)),
    # no batch axis at all
    (("batch", "model"), (8, 8), {"model": 2}, (None, "model")),
    # a named axis: kept if present and dividing
    ((None, "model"), (4, 6), {"data": 2, "model": 4}, (None, None)),
    ((None, "model"), (4, 8), {"data": 2, "model": 4}, (None, "model")),
    (("pod", "data"), (4, 4), {"data": 2, "model": 2}, (None, "data")),
])
def test_resolve_spec_as_the_reference(spec, shape, mesh, want):
    assert layers.resolve_spec(spec, shape, mesh) == want


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    dm = {"data": 2, "model": 4}
    assert sharding.to_placements(("model", "data"), dm) == (Shard(1),
                                                             Shard(0))
    assert sharding.to_placements((None, None), dm) == (Replicate(),
                                                        Replicate())
    assert sharding.to_placements(
        (("pod", "data"), None, "model"),
        {"pod": 2, "data": 2, "model": 2}) == (Shard(0), Shard(0), Shard(2))
    # a mesh dim of size 1 replicates
    assert sharding.to_placements(("model", "data"), {"data": 1, "model": 2}
                                  ) == (Replicate(), Shard(0))
    with pytest.raises(ValueError, match="order"):
        sharding.to_placements((("data", "pod"),),
                               {"pod": 2, "data": 2, "model": 2})
    with pytest.raises(ValueError, match="two tensor dims"):
        sharding.to_placements(("data", "data"), dm)


def test_hints_are_the_identity_without_a_mesh_or_a_dtensor():
    x = torch.ones(8, 4)
    assert mesh_lib.get_mesh() is None
    assert layers.constrain(x, ("batch", "model")) is x
    assert layers.axis_size("model") == 1
    with mesh_lib.use_mesh({"data": 2, "model": 4}):
        assert layers.constrain(x, ("batch", "model")) is x
        assert layers.axis_size("model") == 4
        assert layers.axis_size("pod") == 1
    assert mesh_lib.get_mesh() is None


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    with pytest.raises(ValueError, match="timeout_s"):
        mesh_lib.init_world("file:///nonexistent", 0, 1, device_type="cpu",
                            timeout_s=600)
