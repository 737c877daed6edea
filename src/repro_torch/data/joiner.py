"""Real-time multi-stream sample joining (paper §1.1a / §1.2: the Flink
stage) — counterpart of the reference's ``data/joiner.py``, NumPy only,
so the same offers emit the same samples in both packages. Exposure
events (impressions, carrying feature ids) wait in a time window for
matching feedback events (clicks); on window expiry the joined labeled
sample is emitted — positive if feedback arrived, negative otherwise.

The joiner is columnar and vectorized: exposures are offered as whole
batches (ids + feature matrices), expiry entries live in flat arrays that
one argsort sweep drains per ``drain_batch`` call, and the pending store
is an ``IdHashMap`` (view_id → row) over columnar feature/label arrays.
Batch offers emit the same samples, labels, and (deadline, view_id)
ordering as a per-event dict + heap joiner — stale re-offer expiry
entries included.

Two knobs, both off by default:

* ``emit_on_feedback`` — positives emit the moment their feedback
  arrives instead of waiting for window expiry (negatives still wait
  the full window).
* ``neg_sample_rate`` — window-expiry negatives are down-sampled to this
  rate and the survivors carry a ``1/rate`` correction weight, so the
  weighted loss downstream stays unbiased (positives keep weight 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


def _id_hashmap(capacity: int):
    # deferred: the core package's shard modules import the training
    # plane's neighbours; a module-level core import here would make
    # ``import repro_torch.data`` order-dependent
    from repro_torch.core.hashmap import IdHashMap
    return IdHashMap(capacity)


def _percentile_ring(size: int):
    # deferred for the same reason as _id_hashmap
    from repro_torch.core.monitor import PercentileRing
    return PercentileRing(size)


@dataclass(frozen=True)
class ExposureEvent:
    t: float
    view_id: int
    feature_ids: tuple[int, ...]


@dataclass(frozen=True)
class FeedbackEvent:
    t: float
    view_id: int
    label: float = 1.0


@dataclass
class JoinedSample:
    t_emit: float
    view_id: int
    feature_ids: np.ndarray
    label: float
    join_delay: float      # emit time - exposure time (timeliness metric)
    weight: float = 1.0    # negative-downsampling correction weight


@dataclass
class JoinedBatch:
    """One drain's worth of joined samples, columnar."""

    t_emit: np.ndarray         # (n,) emission times
    view_ids: np.ndarray       # (n,) int64
    feature_ids: np.ndarray    # (n, F) int64
    labels: np.ndarray         # (n,) float32
    join_delay: np.ndarray     # (n,) float32
    weights: np.ndarray        # (n,) float32 downsampling correction

    def __len__(self) -> int:
        return len(self.view_ids)

    def samples(self) -> list[JoinedSample]:
        """Per-event view (the per-event API's ``drain()``)."""
        return [JoinedSample(
            t_emit=float(self.t_emit[i]), view_id=int(self.view_ids[i]),
            feature_ids=self.feature_ids[i].copy(),
            label=float(self.labels[i]),
            join_delay=float(self.join_delay[i]),
            weight=float(self.weights[i]))
            for i in range(len(self))]

    def slice(self, start: int, stop=None) -> "JoinedBatch":
        """Row-range view (numpy slices — no copies)."""
        s = np.s_[start:stop]
        return JoinedBatch(
            t_emit=self.t_emit[s], view_ids=self.view_ids[s],
            feature_ids=self.feature_ids[s], labels=self.labels[s],
            join_delay=self.join_delay[s], weights=self.weights[s])

    @staticmethod
    def empty(fields: int) -> "JoinedBatch":
        z = np.empty(0, np.float64)
        return JoinedBatch(
            t_emit=z, view_ids=np.empty(0, np.int64),
            feature_ids=np.empty((0, fields), np.int64),
            labels=np.empty(0, np.float32),
            join_delay=np.empty(0, np.float32),
            weights=np.empty(0, np.float32))

    @staticmethod
    def concat(batches: list["JoinedBatch"]) -> "JoinedBatch":
        if len(batches) == 1:
            return batches[0]
        return JoinedBatch(
            t_emit=np.concatenate([b.t_emit for b in batches]),
            view_ids=np.concatenate([b.view_ids for b in batches]),
            feature_ids=np.concatenate([b.feature_ids for b in batches]),
            labels=np.concatenate([b.labels for b in batches]),
            join_delay=np.concatenate([b.join_delay for b in batches]),
            weights=np.concatenate([b.weights for b in batches]))


_DELAY_RING = 1 << 14      # recent join delays kept for percentile metrics


class SampleJoiner:
    """Event-time window join over exposure + feedback streams, columnar.

    Expiry entries are append-only flat arrays (one per ``offer``), drained
    by a single mask + lexsort sweep — the vectorized equivalent of the
    per-event heap joiner's, including its re-offer semantics: an entry from
    a previous offer of the same view_id stays live, so a re-offered
    exposure can emit at the earlier offer's deadline (exactly what the
    heap did)."""

    def __init__(self, window: float = 30.0, *,
                 emit_on_feedback: bool = False,
                 neg_sample_rate: float = 1.0,
                 seed: int = 0):
        if not 0.0 < neg_sample_rate <= 1.0:
            raise ValueError(f"neg_sample_rate must be in (0, 1], got "
                             f"{neg_sample_rate}")
        self.window = window
        self.emit_on_feedback = emit_on_feedback
        self.neg_sample_rate = neg_sample_rate
        self._rng = np.random.default_rng(seed)
        # pending rows (columnar; _map: view_id -> row index)
        self._map = _id_hashmap(1024)
        cap = 1024
        self._vid = np.empty(cap, np.int64)
        self._t = np.empty(cap, np.float64)
        self._label = np.zeros(cap, np.float32)
        self._feat: Optional[np.ndarray] = None     # (cap, F), F from 1st offer
        self._live = np.zeros(cap, bool)
        self._rows = 0                 # high-water mark of the row arena
        self._dead = 0                 # rows freed by emit (compaction debt)
        # expiry entries: (deadline, view_id) per offer, append-only
        ecap = 2048
        self._ed = np.empty(ecap, np.float64)
        self._ev = np.empty(ecap, np.int64)
        self._ne = 0
        # counters (surfaced via metrics() → cluster sync_metrics)
        self.late_feedback = 0                        # feedback after emit
        self.emitted = 0
        self.fast_emits = 0            # emit-on-feedback fast-path samples
        self.negatives_dropped = 0     # shed by neg_sample_rate
        # recent join delays for percentile metrics — the shared ring the
        # serving scheduler and sync staleness meter also use
        self._delays = _percentile_ring(_DELAY_RING)

    # ------------------------------------------------------------------
    # storage
    # ------------------------------------------------------------------
    def _grow_rows(self, need: int, fields: int) -> None:
        cap = len(self._vid)
        if self._feat is None:
            self._feat = np.empty((cap, fields), np.int64)
        if need <= cap:
            return
        new_cap = max(need, cap * 2)

        def grow(a):
            out = np.empty((new_cap,) + a.shape[1:], a.dtype)
            out[:cap] = a
            return out

        self._vid = grow(self._vid)
        self._t = grow(self._t)
        self._feat = grow(self._feat)
        lbl = np.zeros(new_cap, np.float32)
        lbl[:cap] = self._label
        self._label = lbl
        live = np.zeros(new_cap, bool)
        live[:cap] = self._live
        self._live = live

    def _compact_rows(self) -> None:
        """Reclaim emitted rows once more than half the arena is dead —
        amortized O(1) per emitted sample."""
        keep = np.flatnonzero(self._live[:self._rows])
        n = len(keep)
        self._vid[:n] = self._vid[keep]
        self._t[:n] = self._t[keep]
        self._feat[:n] = self._feat[keep]
        self._label[:n] = self._label[keep]
        self._live[:n] = True
        self._live[n:self._rows] = False
        self._rows, self._dead = n, 0
        self._map = _id_hashmap(max(16, n * 4))
        if n:
            self._map.insert(self._vid[:n], np.arange(n, dtype=np.int64))

    def _append_entries(self, deadlines: np.ndarray,
                        vids: np.ndarray) -> None:
        n = len(vids)
        if self._ne + n > len(self._ed):
            new_cap = max(self._ne + n, len(self._ed) * 2)
            ed = np.empty(new_cap, np.float64)
            ev = np.empty(new_cap, np.int64)
            ed[:self._ne] = self._ed[:self._ne]
            ev[:self._ne] = self._ev[:self._ne]
            self._ed, self._ev = ed, ev
        self._ed[self._ne:self._ne + n] = deadlines
        self._ev[self._ne:self._ne + n] = vids
        self._ne += n

    # ------------------------------------------------------------------
    # batch API (the hot path)
    # ------------------------------------------------------------------
    def offer_exposures(self, t, view_ids: np.ndarray,
                        feature_ids: np.ndarray) -> None:
        """Offer a batch of exposures at time(s) ``t`` (scalar or (n,)).
        Later occurrences of a duplicate view_id (within the batch or
        across offers) overwrite the pending features/time (a per-event
        joiner's dict semantics) while every offer's expiry entry stays live."""
        view_ids = np.asarray(view_ids, np.int64)
        feature_ids = np.asarray(feature_ids, np.int64)
        n = len(view_ids)
        if n == 0:
            return
        ts = np.broadcast_to(np.asarray(t, np.float64), (n,))
        if self._feat is not None and feature_ids.shape[1] != \
                self._feat.shape[1]:
            raise ValueError("feature_ids width changed mid-stream")
        self._append_entries(ts + self.window, view_ids)

        # strictly monotonic vids (the streaming common case: view ids
        # are assigned sequentially) are unique without the O(n log n)
        # sort a full np.unique dup-check would pay
        if n > 1:
            d = np.diff(view_ids)
            maybe_dup = not ((d > 0).all() or (d < 0).all())
        else:
            maybe_dup = False
        if maybe_dup and len(np.unique(view_ids)) != n:
            # in-batch duplicates: sequential semantics = keep only the
            # LAST occurrence of each vid for the pending store (entries
            # above already cover every offer)
            _, first_of_last = np.unique(view_ids[::-1], return_index=True)
            last = np.zeros(n, bool)
            last[n - 1 - first_of_last] = True
            view_ids, ts = view_ids[last], ts[last]
            feature_ids = feature_ids[last]
            n = len(view_ids)

        sl, have = self._map.lookup_mask(view_ids)
        if have.any():
            rows = sl[have]
            self._t[rows] = ts[have]
            self._feat[rows] = feature_ids[have]
            # label survives a re-offer of a LIVE row (a per-event
            # joiner keeps its labels dict on a duplicate offer)
        miss = ~have
        k = int(miss.sum())
        if k:
            self._grow_rows(self._rows + k, feature_ids.shape[1])
            rows = np.arange(self._rows, self._rows + k)
            self._rows += k
            self._vid[rows] = view_ids[miss]
            self._t[rows] = ts[miss]
            self._feat[rows] = feature_ids[miss]
            self._label[rows] = 0.0
            self._live[rows] = True
            # absent-by-probe above: skip put()'s second existence probe
            self._map.insert(view_ids[miss], rows)

    def offer_feedbacks(self, ts, view_ids: np.ndarray,
                        labels=None) -> Optional[JoinedBatch]:
        """Offer a batch of feedback events. Unmatched feedback counts as
        ``late_feedback`` (the view was already emitted — or never seen).
        With ``emit_on_feedback``, matched positives emit immediately and
        the returned ``JoinedBatch`` carries them (else ``None``)."""
        view_ids = np.asarray(view_ids, np.int64)
        n = len(view_ids)
        if n == 0:
            return None
        ts = np.broadcast_to(np.asarray(ts, np.float64), (n,))
        lbl = np.ones(n, np.float32) if labels is None else \
            np.broadcast_to(np.asarray(labels, np.float32), (n,))

        if self.emit_on_feedback:
            return self._feedback_fast_path(ts, view_ids, lbl)

        sl = self._map.lookup(view_ids)
        have = sl >= 0
        self.late_feedback += int((~have).sum())
        if have.any():
            # later duplicates win (sequential semantics): write in offer
            # order — np.unique keeps the LAST occurrence per row index
            rows, vals = sl[have], lbl[have]
            uniq_rows, last_idx = np.unique(rows[::-1], return_index=True)
            self._label[uniq_rows] = vals[::-1][last_idx]
        return None

    def _feedback_fast_path(self, ts, view_ids, lbl) -> Optional[JoinedBatch]:
        """Matched positive feedback emits NOW; only the first feedback
        per pending view emits (later ones find the row gone → late)."""
        sl = self._map.lookup(view_ids)
        have = sl >= 0
        if have.any():
            rows, vals, fts = sl[have], lbl[have], ts[have]
            # first feedback per row wins the emission
            uniq_rows, first_idx = np.unique(rows, return_index=True)
            dup = len(rows) - len(uniq_rows)
            self.late_feedback += int((~have).sum()) + dup
            rows, vals, fts = uniq_rows, vals[first_idx], fts[first_idx]
            pos = vals > 0
            if (~pos).any():        # negative feedback just labels the row
                self._label[rows[~pos]] = vals[~pos]
            rows, vals, fts = rows[pos], vals[pos], fts[pos]
            if len(rows):
                batch = self._emit_rows(rows, fts, vals,
                                        np.ones(len(rows), np.float32))
                self.fast_emits += len(rows)
                return batch
            return None
        self.late_feedback += len(view_ids)
        return None

    def drain_batch(self, now: float) -> JoinedBatch:
        """Emit every exposure whose window has closed, ordered by
        (deadline, view_id) — a per-event heap's pop order. One mask over the
        entry arrays + one lexsort; window-expiry negatives go through the
        downsampler."""
        ne = self._ne
        if ne == 0 or not (self._ed[:ne] <= now).any():
            return JoinedBatch.empty(self._fields)
        expired = self._ed[:ne] <= now
        exp_d, exp_v = self._ed[:ne][expired], self._ev[:ne][expired]
        keep = ~expired
        k = int(keep.sum())
        self._ed[:k] = self._ed[:ne][keep]
        self._ev[:k] = self._ev[:ne][keep]
        self._ne = k

        # per-event heap order: sort expired entries by (deadline, view_id);
        # the FIRST entry per still-pending vid emits, the rest skip
        order = np.lexsort((exp_v, exp_d))
        exp_v = exp_v[order]
        uniq_v, first = np.unique(exp_v, return_index=True)
        sl = self._map.lookup(uniq_v)
        live = sl >= 0
        if not live.any():
            return JoinedBatch.empty(self._fields)
        # emission order across vids = order of their first expired entry
        emit_order = np.argsort(first[live], kind="stable")
        rows = sl[live][emit_order]
        n = len(rows)
        t_emit = np.full(n, now, np.float64)
        labels = self._label[rows].copy()
        weights = np.ones(n, np.float32)
        if self.neg_sample_rate < 1.0:
            neg = labels <= 0
            drop = neg & (self._rng.random(n) >= self.neg_sample_rate)
            self.negatives_dropped += int(drop.sum())
            weights = np.where(neg, np.float32(1.0 / self.neg_sample_rate),
                               np.float32(1.0))
            sel = ~drop
            # dropped rows leave the pending store too (they expired) —
            # released TOGETHER with the emitted rows below: a partial
            # release here could trigger compaction and invalidate the
            # arena indices still held in ``rows``
            return self._emit_rows(rows[sel], t_emit[sel], labels[sel],
                                   weights[sel], release=rows)
        return self._emit_rows(rows, t_emit, labels, weights)

    def _emit_rows(self, rows: np.ndarray, t_emit: np.ndarray,
                   labels: np.ndarray, weights: np.ndarray,
                   release: Optional[np.ndarray] = None) -> JoinedBatch:
        """Copy out the emitted rows, then release ``release`` (defaults
        to ``rows``) in ONE pass — releasing may compact the arena, so
        every index consumer must run before it."""
        delay = (t_emit - self._t[rows]).astype(np.float32)
        batch = JoinedBatch(
            t_emit=np.asarray(t_emit, np.float64),
            view_ids=self._vid[rows].copy(),
            feature_ids=self._feat[rows].copy(),
            labels=np.asarray(labels, np.float32),
            join_delay=delay,
            weights=np.asarray(weights, np.float32))
        self.emitted += len(rows)
        self._record_delays(delay)
        self._release_rows(rows if release is None else release)
        return batch

    def _release_rows(self, rows: np.ndarray) -> None:
        if not len(rows):
            return
        self._map.delete(self._vid[rows])
        self._live[rows] = False
        self._dead += len(rows)
        if self._dead * 2 > self._rows:
            self._compact_rows()

    def _record_delays(self, delays: np.ndarray) -> None:
        self._delays.record(delays)

    # ------------------------------------------------------------------
    # per-event API (per-event wrappers)
    # ------------------------------------------------------------------
    def offer_exposure(self, ev: ExposureEvent) -> None:
        self.offer_exposures(
            ev.t, np.array([ev.view_id], np.int64),
            np.asarray(ev.feature_ids, np.int64).reshape(1, -1))

    def offer_feedback(self, ev: FeedbackEvent) -> Optional[JoinedBatch]:
        return self.offer_feedbacks(
            ev.t, np.array([ev.view_id], np.int64),
            np.array([ev.label], np.float32))

    def drain(self, now: float) -> list[JoinedSample]:
        return self.drain_batch(now).samples()

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------
    @property
    def _fields(self) -> int:
        return self._feat.shape[1] if self._feat is not None else 0

    @property
    def in_flight(self) -> int:
        return len(self._map)

    def join_delay_percentiles(self, qs=(50, 99)) -> dict[str, float]:
        return self._delays.percentiles(qs)

    def metrics(self) -> dict:
        return {
            "emitted": self.emitted,
            "in_flight": self.in_flight,
            "late_feedback": self.late_feedback,
            "fast_emits": self.fast_emits,
            "negatives_dropped": self.negatives_dropped,
            "join_delay": self.join_delay_percentiles(),
        }

    def register_metrics(self, reg, prefix: str = "joiner") -> None:
        """Publish the joiner counters into a
        ``repro_torch.obs.metrics.MetricsRegistry`` (same keys as
        ``metrics()``, under ``prefix``)."""
        reg.register(prefix, self.metrics)
