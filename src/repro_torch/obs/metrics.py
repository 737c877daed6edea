"""MetricsRegistry: stable dotted names over the repo's ad-hoc dicts.

Every subsystem already keeps counters (`Pusher.pushed_bytes`,
`AdmissionStats`, `ServeCache.stats()`, `_DeviceMirror` sync counts …)
and exposes them through per-plane ``metrics()`` dicts. The registry
gives them one namespace:

* primitives — ``counter(name)`` / ``gauge(name)`` / ``histogram(name)``
  for new code that wants owned metric objects;
* providers — ``register(prefix, fn)`` publishes an *existing* counter
  or dict under a dotted prefix. ``fn`` may take the current clock
  (``fn(now)``) or nothing (``fn()``); arity is detected once at
  registration so collection stays cheap.

``tree(now)`` assembles the nested dict, and ``collect(now)`` flattens
it to ``{"serving.latency.p99": ...}`` dotted names.

Pure stdlib; safe to import from any hot path.
"""

from __future__ import annotations

import inspect
from typing import Callable, Optional


def join(prefix: str, name: str) -> str:
    """Dotted join that tolerates an empty prefix."""
    return f"{prefix}.{name}" if prefix else name


class Counter:
    """Monotonic count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value: either ``set()`` or backed by a callable."""

    __slots__ = ("name", "_value", "_fn")

    def __init__(self, name: str, fn: Optional[Callable[[], float]] = None):
        self.name = name
        self._value = 0.0
        self._fn = fn

    def set(self, value: float) -> None:
        self._value = value

    @property
    def value(self):
        return self._fn() if self._fn is not None else self._value


class Histogram:
    """Windowed reservoir -> count/p50/p99 snapshot (pure python ring)."""

    __slots__ = ("name", "count", "_buf", "_cap", "_i")

    def __init__(self, name: str, window: int = 4096):
        self.name = name
        self.count = 0
        self._cap = int(window)
        self._buf: list = [0.0] * self._cap
        self._i = 0

    def record(self, value: float) -> None:
        self._buf[self._i] = value
        self._i = (self._i + 1) % self._cap
        self.count += 1

    def percentiles(self, qs=(50, 99)) -> dict:
        n = min(self.count, self._cap)
        vals = sorted(self._buf[:n])
        out = {}
        for q in qs:
            if not vals:
                out[f"p{q}"] = 0.0
                continue
            k = (len(vals) - 1) * (q / 100.0)
            lo = int(k)
            hi = min(lo + 1, len(vals) - 1)
            out[f"p{q}"] = vals[lo] + (vals[hi] - vals[lo]) * (k - lo)
        return out

    def snapshot(self) -> dict:
        return {"count": self.count, **self.percentiles()}


class MetricsRegistry:
    """Counters/gauges/histograms + provider dicts under dotted names."""

    def __init__(self):
        self._metrics: dict = {}     # name -> Counter | Gauge | Histogram
        self._providers: list = []   # (prefix, fn, wants_now)
        self._names: set = set()

    # -- owned primitives --------------------------------------------

    def counter(self, name: str) -> Counter:
        return self._add(Counter(name))

    def gauge(self, name: str,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        return self._add(Gauge(name, fn))

    def histogram(self, name: str, window: int = 4096) -> Histogram:
        return self._add(Histogram(name, window))

    def _add(self, m):
        self._claim(m.name)
        self._metrics[m.name] = m
        return m

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
        for name, m in self._metrics.items():
            _set_path(out, name, m.snapshot() if isinstance(m, Histogram)
                      else m.value)
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
