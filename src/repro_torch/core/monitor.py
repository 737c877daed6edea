"""Latency machinery shared by the serving plane's scheduler and metrics.

* ``PercentileRing`` — a fixed-size ring of recent scalar observations
  (predict latencies) answering windowed percentile queries in O(ring).
  It duck-types the downgrade trigger interface (``history`` +
  ``smoothed``).
* ``ManualClock`` — an injectable time source (callable, like
  ``time.perf_counter``) that only advances when told to, so admission
  and latency tests run in exact simulated seconds.

Copied from the reference package's ``core/monitor.py``; the progressive
validators there wait for the training slice of the port.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


class ManualClock:
    """Deterministic injectable time source. Call it like
    ``time.perf_counter`` (the default clock everywhere one is
    injectable); it returns the same instant until ``advance``/``set``
    move it — simulated seconds under test control."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t

    def set(self, t: float) -> float:
        self.t = float(t)
        return self.t


class PercentileRing:
    """Fixed-size ring of recent observations with windowed percentiles.

    ``record`` accepts scalars or arrays; once more than ``size`` values
    have been recorded the oldest are overwritten — memory stays O(size)
    for unbounded streams, and percentiles describe the *recent* window,
    which is what an SLO cares about.

    Trigger duck-typing: ``history`` (sized) + ``smoothed(metric,
    window)`` with metric one of ``p<q>`` / ``mean`` / ``max``.
    """

    def __init__(self, size: int = 1 << 14):
        assert size > 0
        self.size = int(size)
        self._buf = np.zeros(self.size, np.float64)
        self._n = 0                     # total values ever recorded

    def __len__(self) -> int:
        return min(self._n, self.size)

    @property
    def count(self) -> int:
        """Total observations ever recorded (not capped by the ring)."""
        return self._n

    @property
    def history(self):
        """Trigger interface: the retained window, oldest→newest."""
        return self.values()

    def record(self, values) -> None:
        v = np.atleast_1d(np.asarray(values, np.float64))
        n = len(v)
        if n == 0:
            return
        if n >= self.size:              # whole ring replaced — lay the
            # surviving tail at the ring positions its chronological
            # indices map to, so values() reconstructs order correctly
            tail = v[n - self.size:]
            at = (self._n + n - self.size) % self.size
            take = self.size - at
            self._buf[at:] = tail[:take]
            self._buf[:at] = tail[take:]
            self._n += n
            return
        at = self._n % self.size
        take = min(n, self.size - at)
        self._buf[at:at + take] = v[:take]
        if take < n:                    # wrap
            self._buf[:n - take] = v[take:]
        self._n += n

    def values(self) -> np.ndarray:
        """Retained observations in chronological order."""
        n = len(self)
        if self._n <= self.size:
            return self._buf[:n]
        at = self._n % self.size
        return np.concatenate([self._buf[at:], self._buf[:at]])

    def percentiles(self, qs=(50, 99)) -> dict[str, float]:
        n = len(self)
        if n == 0:
            return {f"p{q}": 0.0 for q in qs}
        vals = np.percentile(self._buf[:n], qs)
        return {f"p{q}": float(v) for q, v in zip(qs, vals)}

    def smoothed(self, metric: str, window: Optional[int] = None) -> float:
        """Trigger interface: windowed statistic over the last ``window``
        observations (whole retained ring when None)."""
        vals = self.values()
        if window is not None:
            vals = vals[-window:]
        if len(vals) == 0:
            return math.nan
        if metric == "mean":
            return float(np.mean(vals))
        if metric == "max":
            return float(np.max(vals))
        if metric.startswith("p"):
            return float(np.percentile(vals, float(metric[1:])))
        raise ValueError(f"unknown ring metric {metric!r}")

    def reset(self) -> None:
        self._n = 0

    @staticmethod
    def merged_percentiles(rings: list["PercentileRing"],
                           qs=(50, 99)) -> dict[str, float]:
        """Percentiles over the union of several rings' retained windows."""
        vals = [r.values() for r in rings if len(r)]
        if not vals:
            return {f"p{q}": 0.0 for q in qs}
        cat = np.concatenate(vals)
        out = np.percentile(cat, qs)
        return {f"p{q}": float(v) for q, v in zip(qs, out)}
