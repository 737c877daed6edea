"""Model metrics and latency machinery — counterpart of the reference's
``core/monitor.py``.

Progressive validation (paper §4.3.1): the prediction made on each
training batch *before* its gradients are applied is the evaluation
signal, real-time and lossless.

* ``ProgressiveValidator`` — unbounded per-batch history (exact AUC per
  batch).
* ``StreamingEvaluator`` — bounded per-batch aggregates (weighted logloss
  sums + prediction histograms), so windowed logloss / AUC / calibration
  over the last W batches come from summed aggregates in O(bins).
* ``PercentileRing`` — a fixed-size ring of recent scalar observations
  (predict latencies) answering windowed percentile queries in O(ring).
  It duck-types the downgrade trigger interface (``history`` +
  ``smoothed``).
* ``ManualClock`` — an injectable time source (callable, like
  ``time.perf_counter``) that only advances when told to, so admission
  and latency tests run in exact simulated seconds.

Copied from the reference package's ``core/monitor.py``; both evaluators
duck-type the downgrade trigger interface (``history`` + ``smoothed``).
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np


def logloss(y: np.ndarray, p: np.ndarray, eps: float = 1e-7) -> float:
    p = np.clip(p, eps, 1 - eps)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def auc(y: np.ndarray, p: np.ndarray) -> float:
    """Rank-based AUC (ties averaged)."""
    order = np.argsort(p, kind="mergesort")
    ranks = np.empty(len(p), dtype=np.float64)
    ranks[order] = np.arange(1, len(p) + 1)
    # average ranks for ties
    sp = p[order]
    i = 0
    while i < len(sp):
        j = i
        while j + 1 < len(sp) and sp[j + 1] == sp[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j + 2) / 2.0
        i = j + 1
    n_pos = int(y.sum())
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


@dataclass
class MetricPoint:
    t: float
    step: int
    values: dict[str, float]


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


class ProgressiveValidator:
    """Accumulates predict-before-train metrics per batch."""

    def __init__(self, window: int = 50):
        self.history: list[MetricPoint] = []
        self.window = window

    def observe(self, t: float, step: int, y: np.ndarray,
                p: np.ndarray) -> MetricPoint:
        pt = MetricPoint(t=t, step=step, values={
            "logloss": logloss(y, p),
            "auc": auc(y, p),
            "pctr": float(np.mean(p)),
            "ctr": float(np.mean(y)),
        })
        self.history.append(pt)
        return pt

    def smoothed(self, metric: str, window: Optional[int] = None) -> float:
        """Smoothing over the last ``window`` contrast points (§4.3.2a)."""
        w = window or self.window
        pts = self.history[-w:]
        if not pts:
            return math.nan
        return float(np.mean([p.values[metric] for p in pts]))

    def latest(self, metric: str) -> float:
        return self.history[-1].values[metric] if self.history else math.nan


def _hist_auc(pos: np.ndarray, neg: np.ndarray) -> float:
    """AUC from per-bin positive/negative mass (ties within a bin count
    half — the binned equivalent of rank-based AUC)."""
    p_tot, n_tot = pos.sum(), neg.sum()
    if p_tot <= 0 or n_tot <= 0:
        return 0.5
    neg_below = np.concatenate(([0.0], np.cumsum(neg)[:-1]))
    return float((pos * (neg_below + 0.5 * neg)).sum() / (p_tot * n_tot))


class StreamingEvaluator:
    """Windowed streaming progressive validation from per-batch aggregates.

    ``observe`` folds one pre-update prediction batch into weighted
    aggregates (logloss sum, prediction histograms split by label, pctr /
    ctr sums); windowed metrics sum the last W aggregates — memory is
    O(window × bins) regardless of stream length. ``calibration`` is the
    pCTR/CTR ratio (1.0 = perfectly calibrated), the metric the paper's
    monitoring dashboards track alongside AUC."""

    def __init__(self, window: int = 50, bins: int = 256):
        self.window = window
        self.bins = bins
        self.history: deque = deque(maxlen=window)   # MetricPoint per batch
        self._agg: deque = deque(maxlen=window)      # aligned aggregates

    def observe(self, t: float, step: int, y: np.ndarray, p: np.ndarray,
                weights: Optional[np.ndarray] = None) -> MetricPoint:
        y = np.asarray(y, np.float64)
        p = np.asarray(p, np.float64)
        w = np.ones(len(y)) if weights is None else \
            np.asarray(weights, np.float64)
        eps = 1e-7
        pc = np.clip(p, eps, 1 - eps)
        ll = -(y * np.log(pc) + (1 - y) * np.log(1 - pc))
        bi = np.minimum((p * self.bins).astype(np.int64), self.bins - 1)
        agg = {
            "w": float(w.sum()),
            "ll": float((w * ll).sum()),
            "wp": float((w * p).sum()),
            "wy": float((w * y).sum()),
            "pos": np.bincount(bi, weights=w * y, minlength=self.bins),
            "neg": np.bincount(bi, weights=w * (1 - y),
                               minlength=self.bins),
        }
        self._agg.append(agg)
        point = MetricPoint(t=t, step=step,
                            values=self._windowed(len(self._agg)))
        self.history.append(point)
        return point

    def _windowed(self, w: int) -> dict[str, float]:
        aggs = list(self._agg)[-w:]
        if not aggs:
            return {"logloss": math.nan, "auc": 0.5, "calibration": 1.0,
                    "pctr": math.nan, "ctr": math.nan}
        wsum = sum(a["w"] for a in aggs)
        pos = np.sum([a["pos"] for a in aggs], axis=0)
        neg = np.sum([a["neg"] for a in aggs], axis=0)
        wp = sum(a["wp"] for a in aggs)
        wy = sum(a["wy"] for a in aggs)
        return {
            "logloss": sum(a["ll"] for a in aggs) / max(wsum, 1e-12),
            "auc": _hist_auc(pos, neg),
            "calibration": wp / max(wy, 1e-12),
            "pctr": wp / max(wsum, 1e-12),
            "ctr": wy / max(wsum, 1e-12),
        }

    def smoothed(self, metric: str, window: Optional[int] = None) -> float:
        """Windowed metric over the last ``window`` batches (defaults to
        the evaluator's own window) — the downgrade trigger's read."""
        if not self._agg:
            return math.nan
        return self._windowed(window or self.window)[metric]

    def latest(self, metric: str) -> float:
        return self.history[-1].values[metric] if self.history else math.nan
