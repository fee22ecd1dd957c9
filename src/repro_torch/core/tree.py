"""Parameter and state trees: nested dicts and lists of tensors, walked in
JAX's leaf order (dict keys sorted, lists by index; ``None`` is an empty
subtree). The optimizers, the error-feedback compression and the
checkpoints walk trees this way, so the port's leaves line up one to one
with the reference's ``jax.tree.leaves`` of the same tree.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["flatten_with_path", "leaves", "tree_map", "map_with_path",
           "unflatten"]

Path = tuple


def flatten_with_path(tree: Any, path: Path = (),
                      is_leaf: Callable[[Any], bool] | None = None
                      ) -> list[tuple[Path, Any]]:
    """``[(path, leaf)]`` in JAX's order; a path holds the dict keys and
    list indices from the root. ``is_leaf`` stops the walk at a subtree
    (Adafactor's per-parameter moment dicts)."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_path(tree[k], path + (k,), is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten_with_path(v, path + (i,), is_leaf)]
    return [(path, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *leaves of rest at the same place)`` over ``tree``'s
    structure (``rest`` share it)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def map_with_path(fn: Callable, tree: Any, path: Path = ()) -> Any:
    """``fn(path, leaf)`` over ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def unflatten(like: Any, new_leaves: list) -> Any:
    """A tree shaped like ``like`` holding ``new_leaves`` in JAX's order."""
    it = iter(new_leaves)
    order = {path: next(it) for path, _ in flatten_with_path(like)}
    return map_with_path(lambda path, _: order[path], like)
