"""Atomic manifest checkpoints (the port's twin of
``repro.distributed.checkpoint``), in the reference's layout:

    <dir>/step_<N>/
        manifest.json            # step, meta, one entry a leaf
        arrays/<i>_<name>.npy    # one file a leaf

Everything is written into ``step_<N>.tmp`` and renamed to ``step_<N>``
last: a crash mid-write leaves only a ``.tmp`` directory, which restore
ignores and the next rotation clears. Leaves are flattened in JAX's order
(dict keys sorted, lists by index) and named by the reference's path rule,
so the port restores a checkpoint the reference wrote and the reference's
``restore_checkpoint`` (which reads ``leaves`` and ``meta``, not
``treedef``) reads one the port wrote.

bf16 leaves are stored as the reference stores them, two raw bytes an
element (numpy's ``|V2``) with ``"dtype": "bfloat16"`` in the manifest,
and come back bit for bit without ``ml_dtypes``. The manifest's
``treedef`` is the tree's structure as JSON (the reference writes JAX's
serialized treedef there; neither restore reads it).

On a mesh, the manifest records the logical (unsharded) arrays. Saving a
tree of DTensors gathers each leaf's logical value (a collective: every
rank calls :func:`save_checkpoint`); rank 0 alone writes, and every rank
returns after a barrier, with the checkpoint committed. Restoring with
``shardings=`` (a tree of ``sharding.NamedSharding``) lays each leaf out on
its mesh: any mesh, a different one after an elastic remesh included.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import tree as tree_lib
from repro_torch.distributed import sharding as sharding_lib

Params = Any

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]

_MANIFEST = "manifest.json"


def _leaf_files(tree) -> list[tuple[str, Any]]:
    out = []
    for path, leaf in tree_lib.flatten_with_path(tree):
        name = "_".join(re.sub(r"\W", "", str(k)) for k in path)
        out.append((name or "root", leaf))
    return out


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        raw = t.view(torch.int16).numpy()
        return raw.view(np.dtype("V2")), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        if arr.dtype.kind == "V":       # the bytes as written
            return torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.asarray(arr, np.float32)).to(
            torch.bfloat16)
    return torch.from_numpy(np.require(arr, requirements="C"))


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None if tree is None else "*"


def _writer() -> bool:
    """True on the rank that writes: rank 0 of a process group, or the one
    process outside any."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _logical(leaf) -> torch.Tensor:
    """A leaf's whole value: a DTensor's gathered (a collective)."""
    from torch.distributed.tensor import DTensor
    return leaf.full_tensor() if isinstance(leaf, DTensor) \
        else torch.as_tensor(leaf)


def save_checkpoint(directory: str, step: int, tree: Params,
                    meta: dict | None = None) -> str:
    """Atomically write ``tree`` at ``step``. Returns the committed path.
    In a process group every rank calls it (DTensor leaves are gathered one
    at a time); rank 0 writes, and all return after a barrier."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    writer = _writer()
    if writer:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(os.path.join(tmp, "arrays"))
    manifest = {"step": step, "meta": meta or {}, "leaves": [],
                "treedef": json.dumps(_structure(tree))}
    for i, (name, leaf) in enumerate(_leaf_files(tree)):
        value = _logical(leaf)
        if not writer:
            continue
        arr, dtype = _to_numpy(value)
        fname = f"{i:04d}_{name[:80]}.npy"
        np.save(os.path.join(tmp, "arrays", fname), arr)
        manifest["leaves"].append({"file": fname, "shape": list(arr.shape),
                                   "dtype": dtype})
    if writer:
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # commit point
    if dist.is_initialized():
        dist.barrier()
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, target: Params,
                       shardings: Params | None = None
                       ) -> tuple[Params, dict]:
    """Restore into the structure of ``target`` (a tree of tensors, real or
    on the ``meta`` device): each leaf in the target leaf's dtype, on its
    device (a ``meta`` leaf restores to the CPU). With ``shardings`` (a
    tree of ``sharding.NamedSharding`` shaped like ``target``), each leaf
    becomes a DTensor laid out on its sharding's mesh, on that mesh's
    device — the resharding path: the checkpoint may have been written
    under another mesh, or none. Raises ``ValueError`` on a leaf count or
    shape that does not match."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    flat = tree_lib.leaves(target)
    if len(flat) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"target has {len(flat)}")
    shard_flat = (tree_lib.leaves(shardings) if shardings is not None
                  else [None] * len(flat))
    if len(shard_flat) != len(flat):
        raise ValueError(f"shardings have {len(shard_flat)} leaves, target "
                         f"has {len(flat)}")
    leaves = []
    for spec, info, shard in zip(flat, manifest["leaves"], shard_flat):
        arr = np.load(os.path.join(path, "arrays", info["file"]))
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"shape mismatch for {info['file']}: "
                             f"{arr.shape} vs {tuple(spec.shape)}")
        dev = (shard.mesh.device_type if shard is not None else
               "cpu" if spec.device.type == "meta" else spec.device)
        t = _from_numpy(arr, info["dtype"]).to(device=dev, dtype=spec.dtype)
        leaves.append(t if shard is None else sharding_lib.distribute(t,
                                                                      shard))
    return tree_lib.unflatten(target, leaves), manifest["meta"]


@dataclasses.dataclass
class CheckpointManager:
    """Keep-last-K rotation + convenience save/restore-latest."""
    directory: str
    keep: int = 3

    def save(self, step: int, tree: Params, meta: dict | None = None) -> str:
        path = save_checkpoint(self.directory, step, tree, meta)
        if _writer():
            self._gc()
        return path

    def restore_latest(self, target: Params,
                       shardings: Params | None = None
                       ) -> tuple[int, Params, dict] | None:
        step = latest_step(self.directory)
        if step is None:
            return None
        tree, meta = restore_checkpoint(self.directory, step, target,
                                        shardings)
        return step, tree, meta

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        steps = sorted(int(m.group(1)) for d in os.listdir(self.directory)
                       if (m := re.fullmatch(r"step_(\d+)", d)))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
        # also clear stale tmp dirs (crash debris)
        for d in os.listdir(self.directory):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, d),
                              ignore_errors=True)
