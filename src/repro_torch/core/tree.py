"""Nested dict/list parameter trees — what ``jax.tree_util`` does for the
reference's pytrees, for the port's plain-dict LM parameters.

Leaves are anything that is not a dict or a list (tensors, arrays).
Flattening follows JAX's order: dict keys sorted, list items by index,
so a leaf's path (``"segments/0/pos0/ffn/w_down"``, the reference's
``_path_str``) and its position agree with the reference's flatten.
"""

from __future__ import annotations

from typing import Any, Callable


def flatten_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(path, leaf), ...]`` in JAX's flatten order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, list):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(flatten_with_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in flatten order."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten_like(tree: Any, new_leaves: list) -> Any:
    """A tree of ``tree``'s structure whose leaves, in flatten order, are
    ``new_leaves``."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def map_like(fn: Callable, tree: Any, *others: Any) -> Any:
    """``fn(leaf, *other_subtrees)`` over ``tree``'s leaves, each other
    tree walked in step "up to" ``tree``'s leaves (an optimizer's slot
    dict sits where the param tree has a tensor)."""
    if isinstance(tree, dict):
        return {k: map_like(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_like(fn, v, *(o[i] for o in others))
                for i, v in enumerate(tree)]
    return fn(tree, *others)
