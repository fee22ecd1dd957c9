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

from repro_torch.core import tree as tree_lib

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


def save_checkpoint(directory: str, step: int, tree: Params,
                    meta: dict | None = None) -> str:
    """Atomically write ``tree`` at ``step``. Returns the committed path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, "arrays"))
    manifest = {"step": step, "meta": meta or {}, "leaves": [],
                "treedef": json.dumps(_structure(tree))}
    for i, (name, leaf) in enumerate(_leaf_files(tree)):
        arr, dtype = _to_numpy(torch.as_tensor(leaf))
        fname = f"{i:04d}_{name[:80]}.npy"
        np.save(os.path.join(tmp, "arrays", fname), arr)
        manifest["leaves"].append({"file": fname, "shape": list(arr.shape),
                                   "dtype": dtype})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # commit point
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, target: Params
                       ) -> tuple[Params, dict]:
    """Restore into the structure of ``target`` (a tree of tensors, real or
    on the ``meta`` device): each leaf in the target leaf's dtype, on its
    device (a ``meta`` leaf restores to the CPU). Raises ``ValueError`` on
    a leaf count or shape that does not match."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    flat = tree_lib.leaves(target)
    if len(flat) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"target has {len(flat)}")
    leaves = []
    for spec, info in zip(flat, manifest["leaves"]):
        arr = np.load(os.path.join(path, "arrays", info["file"]))
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"shape mismatch for {info['file']}: "
                             f"{arr.shape} vs {tuple(spec.shape)}")
        dev = "cpu" if spec.device.type == "meta" else spec.device
        leaves.append(_from_numpy(arr, info["dtype"]).to(device=dev,
                                                         dtype=spec.dtype))
    return tree_lib.unflatten(target, leaves), manifest["meta"]


@dataclasses.dataclass
class CheckpointManager:
    """Keep-last-K rotation + convenience save/restore-latest."""
    directory: str
    keep: int = 3

    def save(self, step: int, tree: Params, meta: dict | None = None) -> str:
        path = save_checkpoint(self.directory, step, tree, meta)
        self._gc()
        return path

    def restore_latest(self, target: Params
                       ) -> tuple[int, Params, dict] | None:
        step = latest_step(self.directory)
        if step is None:
            return None
        tree, meta = restore_checkpoint(self.directory, step, target)
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
