"""Sharding rules on a ``DeviceMesh`` (the port's twin of
``repro.distributed.sharding``).

Strategy (the reference's):
  * batch dims shard over ("pod", "data") — pure DP across pods,
  * weight matrices shard TP over "model" on their parallel dim and FSDP
    over "data" on the other (2D sharding: every rank holds 1/(data*model)
    of every weight),
  * MoE expert stacks shard the expert dim over "model" (EP),
  * KV caches shard batch over ("pod","data") and the *sequence* dim over
    "model",
  * Masksembles masks and norms replicate (tiny),
  * stacked-layer leading axes (repeats) never shard.

Rules are keyed on leaf *paths* (``"params/segments/0/b0/attn/wq/w"``),
applied right-aligned to the trailing dims, so one rule covers stacked
[reps, ...] and unstacked [...] parameters. A spec is a tuple with one
entry a tensor dim: None, a mesh dim name, or a tuple of names (that dim
sharded over several mesh dims, major to minor) — the reference's
``PartitionSpec`` as a tuple, equal entry for entry. The rules take a
``DeviceMesh`` or a plain ``{name: size}`` mapping, so they run without a
process group.

A :class:`NamedSharding` pairs a mesh with a spec, as JAX's does; its
``placements`` are DTensor's (one ``Shard``/``Replicate`` a mesh dim,
:func:`to_placements`). :func:`distribute_tree` puts a tree of tensors on
the mesh as DTensors (the twin of ``jax.device_put(tree, shardings)``),
:func:`gather_tree` assembles each logical value back (a collective: every
rank calls it).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch

from repro_torch.core import tree as tree_lib
from repro_torch.launch import mesh as mesh_lib

Params = Any

__all__ = ["batch_axes", "param_pspec", "param_shardings", "tree_shardings",
           "batch_shardings", "cache_shardings", "replicated", "PARAM_RULES",
           "NamedSharding", "to_placements", "distribute", "distribute_tree",
           "gather_tree", "whole", "whole_bytes"]


def batch_axes(mesh) -> tuple[str, ...]:
    return (("pod", "data") if "pod" in mesh_lib.mesh_shape(mesh)
            else ("data",))


# (path-regex, trailing-dims spec). First match wins. Specs name logical
# trailing dims right-aligned against the leaf shape. Verbatim from the
# reference: this table is the spec.
PARAM_RULES: tuple[tuple[str, tuple], ...] = (
    # --- embeddings ---------------------------------------------------------
    (r"embed/embed$",            ("model", "data")),    # [V, D]
    (r"embed/unembed/w$",        ("data", "model")),    # [D, V]
    # --- attention ----------------------------------------------------------
    (r"attn/w[qkv]/w$",          ("data", "model")),    # [D, H*dh]
    (r"attn/w[qkv]/b$",          ("model",)),
    (r"attn/wo/w$",              ("model", "data")),    # [H*dh, D]
    (r"attn/wo/b$",              (None,)),
    # --- gated / plain FFN ---------------------------------------------------
    (r"ffn/w[gu]/w$",            ("data", "model")),    # [D, F]
    (r"ffn/w[gu]/b$",            ("model",)),
    (r"ffn/wd/w$",               ("model", "data")),    # [F, D]
    (r"ffn/wd/b$",               (None,)),
    # packed serving form (mask-zero skipping): [.., N, D, K] / [.., N, K, D]
    (r"ffn/w[gu]p$",             ("data", "model")),
    (r"ffn/wdp$",                ("model", "data")),
    # --- MoE (experts lead) ---------------------------------------------------
    (r"moe/router/w$",           ("data", None)),       # [D, E]
    (r"moe/we[gu]$",             ("model", "data", None)),  # [E, D, F]
    (r"moe/wed$",                ("model", None, "data")),  # [E, F, D]
    (r"moe/dense/w[gu]/w$",      ("data", "model")),
    (r"moe/dense/wd/w$",         ("model", "data")),
    # --- RG-LRU ---------------------------------------------------------------
    (r"rec/wgate/w$",            ("data", "model")),
    (r"rec/win/w$",              ("data", "model")),
    (r"rec/wout/w$",             ("model", "data")),
    (r"rec/(wgate|win|wout)/b$", ("model",)),
    (r"rec/conv$",               (None, "model")),      # [K, W]
    (r"rec/lru/w[ax]/w$",        ("data", "model")),    # [W, W]
    (r"rec/lru/w[ax]/b$",        ("model",)),
    (r"rec/lru/lambda$",         ("model",)),
    # --- xLSTM -----------------------------------------------------------------
    (r"w[ug]/w$",                ("data", "model")),    # block up-projections
    (r"w[ug]/b$",                ("model",)),
    (r"w[qkv]$",                 (None, "data", "model")),  # [H, pdh, pdh]
    (r"wif/w$",                  ("data", None)),
    (r"wzifo/w$",                ("data", "model")),
    (r"wzifo/b$",                ("model",)),
    (r"rzifo$",                  (None, "data", "model")),
    (r"wd/w$",                   ("model", "data")),
    (r"wd/b$",                   (None,)),
    # --- everything else (norms, masks, biases, scalars): replicate ----------
    (r".*",                      ()),
)


def _path_str(path) -> str:
    return path if isinstance(path, str) else "/".join(str(k) for k in path)


def param_pspec(path, leaf, mesh) -> tuple:
    """The spec of one parameter leaf (path-matched, right-aligned; mesh
    axes that are absent, or do not divide the dim, dropped).

    Optimizer-state trees reuse the same rules: Adam moments mirror the
    parameter paths; Adafactor's factored moments (leaf names ``vr``/``vc``)
    match their *parent* parameter rule with the reduced dim removed (vr
    drops the last dim, vc the second-to-last)."""
    s = _path_str(path)
    sizes = mesh_lib.mesh_shape(mesh)
    factored = None
    if s.endswith("/vr") or s.endswith("/vc"):
        factored, s = s[-2:], s[:-3]
    shape = tuple(leaf.shape)
    ndim = len(shape)
    for pat, spec in PARAM_RULES:
        if re.search(pat, s):
            spec = tuple(a if (a in sizes) else None for a in spec)
            if factored == "vr" and spec:
                spec = spec[:-1]
            elif factored == "vc" and len(spec) >= 2:
                spec = spec[:-2] + spec[-1:]
            spec = spec[-ndim:] if ndim < len(spec) else spec
            full = (None,) * (ndim - len(spec)) + tuple(spec)
            # drop axes that don't divide the dim (e.g. kv-head counts)
            return tuple(a if (a is not None and shape[i] % sizes[a] == 0)
                         else None for i, a in enumerate(full))
    return ()


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``): ``placements`` are the
    DTensor placements it means on that mesh."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def to_placements(spec: tuple, mesh) -> tuple:
    """One ``Shard(dim)``/``Replicate()`` a mesh dim, in the mesh's dim
    order. An entry naming several mesh dims (``("pod", "data")``) shards
    that tensor dim over each of them; DTensor splits it over the mesh dims
    in mesh order, so the entry must list them in that order (the
    reference's major-to-minor). A mesh dim of size 1 replicates: one shard
    is the whole dim, and DTensor refuses views that would merge a dim it
    holds as sharded."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_lib.mesh_shape(mesh)
    names = list(sizes)
    owner: dict[str, int] = {}
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        if [names.index(a) for a in axes] != sorted(
                names.index(a) for a in axes):
            raise ValueError(f"spec entry {entry} lists mesh dims out of "
                             f"the mesh's order {tuple(names)}")
        for a in axes:
            if a in owner:
                raise ValueError(f"mesh dim {a!r} shards two tensor dims "
                                 f"in spec {spec}")
            owner[a] = dim
    return tuple(Shard(owner[n]) if n in owner and sizes[n] > 1
                 else Replicate() for n in names)


def param_shardings(mesh, params: Params) -> Params:
    """A :class:`NamedSharding` a leaf of ``params`` (real tensors or
    ``meta`` stand-ins alike)."""
    return tree_shardings(
        mesh, params, lambda path, leaf: param_pspec(path, leaf, mesh))


def tree_shardings(mesh, tree: Params, pspec_fn) -> Params:
    """``NamedSharding(mesh, pspec_fn(path, leaf))`` a leaf."""
    return tree_lib.map_with_path(
        lambda path, leaf: NamedSharding(mesh, pspec_fn(path, leaf)), tree)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def batch_shardings(mesh, batch: Params) -> Params:
    """Training/serving inputs: shard dim 0 (batch) over ("pod","data");
    positions [3,B,S] shard dim 1; scalars, and batches the data ranks do
    not divide, replicate."""
    sizes = mesh_lib.mesh_shape(mesh)
    ba = batch_axes(mesh)
    nshards = 1
    for a in ba:
        nshards *= sizes[a]

    def spec(path, leaf):
        name = _path_str(path)
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        bdim = 1 if name.endswith("positions") and shape[0] == 3 else 0
        if shape[bdim] % nshards == 0:
            full: list = [None] * len(shape)
            full[bdim] = ba[0] if len(ba) == 1 else ba
            return tuple(full)
        return ()

    return tree_shardings(mesh, batch, spec)


def cache_shardings(mesh, cache: Params) -> Params:
    """KV caches [reps, B, Hkv, S, dh]: batch over ("pod","data"), sequence
    over "model" (distributed decode softmax). Recurrent states
    [reps, B, W]: batch + width over "model". kpos replicates."""
    sizes = mesh_lib.mesh_shape(mesh)
    ba = batch_axes(mesh)
    bspec = ba if len(ba) > 1 else ba[0]
    nshards = 1
    for a in ba:
        nshards *= sizes[a]

    def spec(path, leaf):
        name = _path_str(path)
        if name.endswith("kpos"):
            return ()
        shape = tuple(leaf.shape)
        s: list = [None] * len(shape)
        if name.endswith("/k") or name.endswith("/v"):
            # [reps, B, Hkv, S, dh]
            if shape[1] % nshards == 0:
                s[1] = bspec
            if shape[3] % sizes["model"] == 0:
                s[3] = "model"
            return tuple(s)
        # recurrent states: [reps, B, ...] — batch + last dim over model
        if len(shape) >= 2 and shape[1] % nshards == 0:
            s[1] = bspec
        if len(shape) >= 3 and shape[-1] % sizes["model"] == 0:
            s[-1] = "model"
        return tuple(s)

    return tree_shardings(mesh, cache, spec)


def distribute(leaf: torch.Tensor, sharding: NamedSharding):
    """``leaf`` as a DTensor laid out by ``sharding``. Every rank passes
    the same value and keeps its own shard, with no communication."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(leaf.detach(), sharding.mesh,
                             sharding.placements, src_data_rank=None)


def distribute_tree(tree: Params, shardings: Params) -> Params:
    """Each leaf of ``tree`` as :func:`distribute` lays it out by its
    :class:`NamedSharding` in ``shardings`` (a tree of the same structure):
    the twin of ``jax.device_put(tree, shardings)``."""
    return tree_lib.tree_map(distribute, tree, shardings)


def gather_tree(tree: Params) -> Params:
    """Each DTensor leaf's logical value as a plain tensor (a collective:
    every rank calls it); plain leaves as they are."""
    from torch.distributed.tensor import DTensor
    return tree_lib.tree_map(
        lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's logical value as this rank's plain tensor (every sharded
    mesh dim gathered, a partial sum reduced: a collective, every rank
    calls it); a plain tensor as it is. A DTensor that is replicated
    already hands back its local tensor, with no copy."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    return t.redistribute(mesh, (Replicate(),) * mesh.ndim).to_local()


def whole_bytes(t: torch.Tensor) -> int:
    """The bytes :func:`whole` adds on this rank: the full value's less the
    local shard's (0 for a plain or a replicated tensor)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return 0
    return (t.numel() - t.to_local().numel()) * t.element_size()
