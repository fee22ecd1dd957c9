"""The port's launch layer on the CPU: the dry-run cells, the production
meshes over a ``fake`` process group, the per-device cost count and the
dry-run of small qwen2 cells against the reference's own numbers.

Every test that opens a fake process group destroys it before it returns
(``dryrun.fake_world``), so the xdist worker that runs the next file sees
no group. The reference's numbers come from one subprocess, as
``tests/test_launch.py`` gets them (the reference's dry-run sets its
host-device count at import), without lowering anything: its
``model_flops`` and its ``_sharded_bytes`` over its own spec and sharding
trees.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import cells as j_cells
from repro_torch.configs import cells as t_cells
from repro_torch.launch import dryrun, sweep
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import xlstm

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
#: tests/test_launch.py's width-reduced qwen2 overrides.
SMALL = dict(n_layers=2, d_model=256, n_heads=16, n_kv_heads=8, head_dim=16,
             d_ff=512, vocab_size=2048)
SHAPES = ("train_4k", "prefill_32k", "decode_32k")

_REFERENCE = """
from repro.launch import dryrun   # sets the host-device count first
import json
from repro.configs import SHAPES
from repro.distributed import sharding
from repro.launch.mesh import make_production_mesh
from repro.models import build_model
from repro.optim import build_optimizer
from repro.train import train_state_specs
out = {}
for name in %r:
    shape = SHAPES[name]
    cfg = dryrun._cell_config("qwen2-1.5b", 0, %r)
    model = build_model(cfg)
    mesh = make_production_mesh(multi_pod=False)
    if shape.kind == "train":
        opt = build_optimizer(dryrun.pick_optimizer(cfg))
        specs = train_state_specs(model, opt, compress=False)
        trees = [(specs, sharding.param_shardings(mesh, specs))]
    else:
        ps = model.param_specs()
        cs = model.cache_specs(shape.global_batch, shape.seq_len)
        trees = [(ps, sharding.param_shardings(mesh, ps)),
                 (cs, sharding.cache_shardings(mesh, cs))]
    out[name] = {"model_flops": dryrun.model_flops(cfg, shape),
                 "resident": sum(dryrun._sharded_bytes(s, sh)
                                 for s, sh in trees)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _REFERENCE % (SHAPES, SMALL)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cells_are_the_references():
    got = [(c.name, c.skip) for c in t_cells.enumerate_cells()]
    want = [(c.name, c.skip) for c in j_cells.enumerate_cells()]
    assert got == want
    assert len(got) == 40
    assert [c.name for c in t_cells.runnable_cells()] == \
        [c.name for c in j_cells.runnable_cells()]


@pytest.mark.parametrize("multi_pod,size,names", [
    (False, 256, ("data", "model")), (True, 512, ("pod", "data", "model"))])
def test_production_mesh_on_a_fake_group(multi_pod, size, names):
    with dryrun.fake_world(size):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device_type="cpu")
        assert mesh.size() == size
        assert mesh.mesh_dim_names == names
        assert tuple(mesh.shape) == (mesh_lib.MULTI_POD_SHAPE if multi_pod
                                     else mesh_lib.SINGLE_POD_SHAPE)
        with pytest.raises(ValueError, match="world"):
            mesh_lib.make_production_mesh(multi_pod=not multi_pod,
                                          device_type="cpu")
    assert not torch.distributed.is_initialized()


def test_local_flops_are_a_devices_share():
    """[1024, 4096] @ [4096, 8192], rows over "data" and columns over
    "model" on the (16, 16) mesh: a device computes 1/256 of the product,
    and that is what ``LocalCosts`` counts, where ``FlopCounterMode``
    counts the global product."""
    with dryrun.fake_world(256):
        mesh = mesh_lib.make_production_mesh(device_type="cpu")
        x = DTensor.from_local(torch.empty(64, 4096, device="meta"), mesh,
                               (Shard(0), Replicate()), run_check=False,
                               shape=(1024, 4096), stride=(4096, 1))
        w = DTensor.from_local(torch.empty(4096, 512, device="meta"), mesh,
                               (Replicate(), Shard(1)), run_check=False,
                               shape=(4096, 8192), stride=(8192, 1))
        costs = dryrun.LocalCosts()
        with costs:
            y = x @ w
        with FlopCounterMode(display=False) as fc:
            x @ w
    full = 2 * 1024 * 4096 * 8192
    assert tuple(y.to_local().shape) == (64, 512)
    assert costs.flops == full // 256
    assert fc.get_total_flops() == full
    assert costs.bytes == (64 * 4096 + 4096 * 512 + 64 * 512) * 4
    assert sum(costs.collectives.values()) == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_small_qwen2_cell_matches_the_reference(reference, shape):
    """The dry-run of ``tests/test_launch.py``'s reduced qwen2 on the
    single-pod mesh: 256 devices, the reference's model FLOPs and resident
    bytes, per-device FLOPs and bytes, collective bytes, an H100
    roofline."""
    r = dryrun.run_cell("qwen2-1.5b", shape, overrides=dict(SMALL))
    assert not torch.distributed.is_initialized()
    assert r["n_chips"] == 256 and r["mesh"] == {"data": 16, "model": 16}
    assert r["roofline"]["model_flops_total"] == \
        reference[shape]["model_flops"]
    assert r["memory_analytic"]["resident_state_bytes"] == \
        reference[shape]["resident"]
    assert r["cost"]["hlo_flops_per_device"] > \
        r["roofline"]["model_flops_per_device"] / 4
    assert r["cost"]["hlo_bytes_per_device"] > 0
    assert sum(r["collectives"].values()) > 0
    assert r["roofline"]["device"] == "h100-sxm5-80gb"
    assert r["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert r["memory_analytic"]["fits_h100_80gb_analytic"]


def test_multi_pod_train_cell_runs_on_512():
    """The multi-pod mesh (2, 16, 16) ("pod", "data", "model") in a train
    cell: 512 devices, the pod axis in the batch's shards, the int8
    error-feedback state in the resident bytes."""
    r = dryrun.run_cell("qwen2-1.5b", "train_4k", multi_pod=True,
                        overrides=dict(SMALL))
    single = dryrun.run_cell("qwen2-1.5b", "train_4k", overrides=dict(SMALL))
    assert r["n_chips"] == 512
    assert r["mesh"] == {"pod": 2, "data": 16, "model": 16}
    assert r["memory_analytic"]["resident_state_bytes"] > \
        single["memory_analytic"]["resident_state_bytes"]
    assert r["roofline"]["model_flops_per_device"] * 2 == \
        single["roofline"]["model_flops_per_device"]
    assert sum(r["collectives"].values()) > 0


def test_sweep_writes_a_skip_record(tmp_path):
    cell = next(c for c in t_cells.enumerate_cells() if c.skip)
    got = sweep.run_cell(cell, "single", str(tmp_path))
    path = tmp_path / "single" / f"{cell.arch_id}__{cell.shape.name}.json"
    with open(path) as f:
        assert json.load(f) == got == {"arch": cell.arch_id,
                                       "shape": cell.shape.name,
                                       "skipped": cell.skip}


def test_arctic_train_cell_traces_at_published_widths():
    """arctic-480b's ``train_4k`` at its published widths, cut to 1 layer
    (the smallest cut that raised before the MoE products were written as
    ``bmm``s over contiguous operands: DTensor's backward viewed a permuted
    local shard, [8, 2048, 10, 1, 7168], by its global layout's strides):
    it traces, and its record's cost, collectives and roofline are
    filled."""
    r = dryrun.run_cell("arctic-480b", "train_4k", overrides={"n_layers": 1})
    assert not torch.distributed.is_initialized()
    assert r["cost"]["hlo_flops_per_device"] > \
        r["roofline"]["model_flops_per_device"] / 4
    assert r["cost"]["hlo_bytes_per_device"] > 0
    assert r["collectives"]["all-gather"] > 0
    assert r["collectives"]["all-reduce"] > 0
    assert r["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert r["roofline"]["bound_s"] > 0


#: xlstm-350m at its published widths, one layer, and that layer an sLSTM.
ONE_SLSTM = {"n_layers": 1, "slstm_every": 1}


@pytest.mark.parametrize("shape,layers", [
    ("train_4k", ONE_SLSTM), ("prefill_32k", ONE_SLSTM),
    ("train_4k", {"n_layers": 2, "slstm_every": 2})])
def test_slstm_count_one_step_equals_the_full_loop(monkeypatch, shape,
                                                   layers):
    """At S = 64 the dry-run's sLSTM scan counted from one step
    (``dryrun.counted_scan``) counts what the whole loop counts: the same
    FLOPs, bytes and collective bytes, forward and backward. A first
    trace warms DTensor's caches, so both compared traces see the same."""
    monkeypatch.setitem(dryrun.SHAPES, shape, dataclasses.replace(
        dryrun.SHAPES[shape], seq_len=64))

    def trace(whole_loop):
        with monkeypatch.context() as m:
            if whole_loop:      # the stand-in hands back the real loop
                m.setattr(dryrun, "counted_scan",
                          lambda costs: xlstm.time_scan)
            _, c = dryrun.trace_cell("xlstm-350m", shape, mesh,
                                     overrides=layers)
        return c.flops, c.bytes, c.collectives

    with dryrun.fake_world(256):
        mesh = mesh_lib.make_production_mesh(device_type="cpu")
        trace(False)
        counted, whole = trace(False), trace(True)
    assert counted == whole
    assert counted[0] > 0 and counted[1] > 0


#: The xlstm-350m ``train_4k`` trace's limit on this host, against the
#: whole loop's > 900 s for 24 layers before the scan counted one step
#: (about 0.1 s a step and layer: more than 300 s for the one layer here).
XLSTM_TRACE_LIMIT_S = 120.0


def test_xlstm_train_cell_traces_within_its_limit():
    """xlstm-350m ``train_4k`` at its published widths and full sequence,
    cut to its one sLSTM layer: the trace ends within
    :data:`XLSTM_TRACE_LIMIT_S` (about 6 s alone on an 8-core host)."""
    t0 = time.perf_counter()
    r = dryrun.run_cell("xlstm-350m", "train_4k", overrides=ONE_SLSTM)
    seconds = time.perf_counter() - t0
    assert seconds < XLSTM_TRACE_LIMIT_S, seconds
    assert r["cost"]["hlo_flops_per_device"] > 0
    assert sum(r["collectives"].values()) > 0
