"""Walking the benchmark's nested parameter dicts."""

from __future__ import annotations


def paths(tree, prefix: str = "") -> list:
    """``[(path, leaf), ...]``: dict keys sorted, list items by index,
    joined with ``/``."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, list):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(paths(v, f"{prefix}/{k}" if prefix else k))
    return out
