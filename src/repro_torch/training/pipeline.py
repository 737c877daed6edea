"""TrainPipeline: the online ingest path of the training plane —
counterpart of the reference's ``training/pipeline.py``.

    stream events ─► SampleJoiner (vectorized window join)
        │               └ emit-on-feedback fast path (positives) and
        │                 negative downsampling w/ correction weights
        ▼
    sample buffer ──► pad-to-bucket micro-batches ──► train_batch
        │
        └ BACKPRESSURE: before training, the pipeline reads the sync
          plane's consumer lag (``Scatter.lag()`` via ``lag_fn``). Above
          ``max_sync_lag`` records it *throttles* — samples stay
          buffered, no updates are pushed, so training cannot outrun
          deployment. If the buffer then outgrows ``buffer_cap``
          examples, the OLDEST samples are *shed* and counted.

All counters (joiner late_feedback / join-delay percentiles, shed and
throttle counts) surface through ``metrics()`` and the metrics registry.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Optional

import numpy as np

from repro_torch.data.joiner import JoinedBatch, SampleJoiner
from repro_torch.data.streams import EventBatch
from repro_torch.training.plane import TrainingPlane
from repro_torch.training.registry import TrainScenario

# pow2 ladder, same as serving's DEFAULT_BUCKETS: worst-case padding <50 %
TRAIN_BUCKETS = (128, 256, 512, 1024, 2048, 4096)


class TrainPipeline:
    """stream → join → admit → dedup/coalesce → bucketed train for ONE
    training scenario."""

    def __init__(self, plane: TrainingPlane, scn: TrainScenario,
                 joiner: SampleJoiner, *,
                 buckets: tuple[int, ...] = TRAIN_BUCKETS,
                 lag_fn: Optional[Callable[[], int]] = None,
                 max_sync_lag: Optional[int] = None,
                 buffer_cap: int = 1 << 16):
        if not buckets:
            raise ValueError("need at least one bucket size")
        self.plane = plane
        self.scn = scn
        self.joiner = joiner
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.lag_fn = lag_fn
        self.max_sync_lag = max_sync_lag
        self.buffer_cap = buffer_cap
        # deque: _take/_shed consume from the head (oldest first) batch
        # by batch — popleft is O(1) where list.pop(0) shifts the tail
        self._buf: deque[JoinedBatch] = deque()
        self._buffered = 0
        # feedback waits here until its event time arrives — delivering
        # it early would let the join window see "future" clicks and
        # nullify the timeliness vs. model-effect trade-off
        self._fb_t = np.empty(0, np.float64)
        self._fb_v = np.empty(0, np.int64)
        self.throttled_ticks = 0
        self.shed_examples = 0
        scn.pipeline = self

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------
    def ingest(self, batch: EventBatch) -> None:
        """Offer one tick's columnar events: exposures immediately,
        feedback queued until its event time matures (delivered here and
        at every ``tick``). Fast-path emissions (emit-on-feedback
        positives) land in the buffer as their feedback arrives;
        window-expiry emissions arrive at the next tick."""
        self.joiner.offer_exposures(batch.t, batch.view_ids,
                                    batch.feature_ids)
        self._fb_t = np.concatenate([self._fb_t, batch.fb_t])
        self._fb_v = np.concatenate([self._fb_v, batch.fb_view_ids])
        self._deliver_feedback(batch.t)

    def _deliver_feedback(self, now: float) -> None:
        """Offer every queued feedback row whose event time has arrived,
        in event-time order."""
        due = self._fb_t <= now
        if not due.any():
            return
        order = np.argsort(self._fb_t[due], kind="stable")
        fast = self.joiner.offer_feedbacks(self._fb_t[due][order],
                                           self._fb_v[due][order])
        self._fb_t, self._fb_v = self._fb_t[~due], self._fb_v[~due]
        if fast is not None and len(fast):
            self._buffer(fast)

    def _buffer(self, batch: JoinedBatch) -> None:
        self._buf.append(batch)
        self._buffered += len(batch)
        self._shed_if_over()

    def _shed_if_over(self) -> None:
        """Drop exactly the OLDEST samples over ``buffer_cap`` (they are
        the stalest), slicing partway into a batch when needed."""
        while self._buffered > self.buffer_cap and self._buf:
            over = self._buffered - self.buffer_cap
            head = self._buf[0]
            if len(head) <= over:
                self._buf.popleft()
                self._buffered -= len(head)
                self.shed_examples += len(head)
            else:
                self._buf[0] = head.slice(over)
                self._buffered -= over
                self.shed_examples += over

    # ------------------------------------------------------------------
    # drive
    # ------------------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def tick(self, now: float, *, flush: bool = False) -> list[dict]:
        """Deliver matured feedback, drain the join window into the
        buffer, then train full buckets (every remaining sample too,
        padded, when ``flush``). Throttles — trains nothing — while the
        sync plane's lag exceeds the bound."""
        self._deliver_feedback(now)       # before the expiry sweep: a
        # click due at ``now`` beats a window that closes at ``now``
        drained = self.joiner.drain_batch(now)
        if len(drained):
            self._buffer(drained)
        if self.max_sync_lag is not None and self.lag_fn is not None \
                and self.lag_fn() > self.max_sync_lag:
            self.throttled_ticks += 1
            return []
        out = []
        top = self.buckets[-1]
        while self._buffered >= self.buckets[0] or \
                (flush and self._buffered):
            ids, y, w = self._take(min(self._buffered, top))
            out.append(self.plane.train_batch(
                self.scn, ids, y, weights=w, now=now,
                bucket=self.bucket_for(len(ids))))
        return out

    def flush(self, now: float) -> list[dict]:
        return self.tick(now, flush=True)

    def _take(self, n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pop the ``n`` oldest buffered samples as one train batch."""
        take, got = [], 0
        while got < n and self._buf:
            b = self._buf[0]
            need = n - got
            if len(b) <= need:
                take.append(b)
                got += len(b)
                self._buf.popleft()
            else:
                take.append(b.slice(0, need))
                self._buf[0] = b.slice(need)
                got = n
        self._buffered -= got
        merged = JoinedBatch.concat(take)
        return merged.feature_ids, merged.labels, merged.weights

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------
    @property
    def buffered(self) -> int:
        return self._buffered

    def metrics(self) -> dict:
        return {
            "joiner": self.joiner.metrics(),
            "buffered": self._buffered,
            "pending_feedback": len(self._fb_v),
            "throttled_ticks": self.throttled_ticks,
            "shed_examples": self.shed_examples,
        }

    def register_metrics(self, reg, prefix: str = "pipeline") -> None:
        """Publish the pipeline counters (and its joiner's) into a
        ``repro_torch.obs.metrics.MetricsRegistry``."""
        from repro_torch.obs.metrics import join
        self.joiner.register_metrics(reg, join(prefix, "joiner"))
        reg.register(join(prefix, "buffered"), lambda: self._buffered)
        reg.register(join(prefix, "pending_feedback"),
                     lambda: len(self._fb_v))
        reg.register(join(prefix, "throttled_ticks"),
                     lambda: self.throttled_ticks)
        reg.register(join(prefix, "shed_examples"),
                     lambda: self.shed_examples)
