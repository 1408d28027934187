"""Parameter and gradient trees: tensors nested in dicts and lists (the
role ``jax.tree_util`` plays for the JAX package's pytrees)."""
from __future__ import annotations

from typing import Callable


def tree_leaves(tree) -> list:
    """The tensors of a tree, in a fixed order: dict keys sorted, as
    ``jax.tree_util`` orders them."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tree_leaves(x)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same places of
    ``rest``) in ``tree_leaves``' order, keeping its dict/list
    structure."""
    if isinstance(tree, dict):
        # visit the leaves in tree_leaves' order, keep the dict's own
        done = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
        out = {k: done[k] for k in tree}
        if type(tree) is not dict:  # a dict subclass keeps its attributes
            kept = type(tree)(out)
            kept.__dict__.update(tree.__dict__)
            return kept
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)
