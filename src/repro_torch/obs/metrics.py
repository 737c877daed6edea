"""MetricsRegistry: stable dotted names over the repo's ad-hoc dicts.

Every subsystem already keeps counters (`Pusher.pushed_bytes`,
`AdmissionStats`, `ServeCache.stats()`, `_DeviceMirror` sync counts …)
and exposes them through per-plane ``metrics()`` dicts. The registry
gives them one namespace: ``register(prefix, fn)`` publishes an
*existing* counter or dict under a dotted prefix. ``fn`` may take the
current clock (``fn(now)``) or nothing (``fn()``); arity is detected
once at registration so collection stays cheap.

``tree(now)`` assembles the nested dict, and ``collect(now)`` flattens
it to ``{"serving.latency.p99": ...}`` dotted names.

Pure stdlib; safe to import from any hot path.
"""

from __future__ import annotations

import inspect
from typing import Callable


def join(prefix: str, name: str) -> str:
    """Dotted join that tolerates an empty prefix."""
    return f"{prefix}.{name}" if prefix else name


class MetricsRegistry:
    """Provider dicts under dotted names."""

    def __init__(self):
        self._providers: list = []   # (prefix, fn, wants_now)
        self._names: set = set()

    # -- providers ----------------------------------------------------

    def register(self, prefix: str, fn: Callable) -> None:
        """Publish ``fn``'s scalar-or-nested-dict result under
        ``prefix``. ``fn`` may accept the collection clock (``fn(now)``)
        or no arguments."""
        self._claim(prefix)
        try:
            wants_now = len(inspect.signature(fn).parameters) >= 1
        except (TypeError, ValueError):  # builtins without signatures
            wants_now = False
        self._providers.append((prefix, fn, wants_now))

    def _claim(self, name: str) -> None:
        if not name and self._names:
            raise ValueError("empty prefix collides with everything")
        if name in self._names:
            raise ValueError(f"metric {name!r} already registered")
        self._names.add(name)

    # -- collection ---------------------------------------------------

    def tree(self, now: float = 0.0) -> dict:
        """The nested metrics dict (dotted names split into levels)."""
        out: dict = {}
        for prefix, fn, wants_now in self._providers:
            _set_path(out, prefix, fn(now) if wants_now else fn())
        return out

    def collect(self, now: float = 0.0) -> dict:
        """Flat ``{dotted name: leaf value}`` view of ``tree(now)``."""
        return _flatten(self.tree(now))

    def names(self, now: float = 0.0) -> list:
        """Sorted dotted leaf names currently published."""
        return sorted(self.collect(now))


def _set_path(out: dict, dotted: str, value) -> None:
    parts = dotted.split(".") if dotted else []
    if not parts:
        if isinstance(value, dict):
            out.update(value)
        return
    node = out
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    leaf = parts[-1]
    if isinstance(value, dict) and isinstance(node.get(leaf), dict):
        node[leaf].update(value)
    else:
        node[leaf] = value


def _flatten(tree: dict, prefix: str = "") -> dict:
    flat: dict = {}
    for k, v in tree.items():
        name = join(prefix, str(k))
        if isinstance(v, dict):
            flat.update(_flatten(v, name))
        else:
            flat[name] = v
    return flat
