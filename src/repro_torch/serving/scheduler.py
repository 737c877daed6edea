"""Micro-batching request scheduler for the predict path, with serve-side
admission control.

Concurrent predict requests are admitted into a pending window, coalesced
into one id tensor, and executed in fixed-size *buckets*: each chunk is
padded up to the smallest configured bucket that covers it, so the predict
runs at a few fixed shapes instead of one per request shape, and
per-request dispatch overhead is paid once per bucket. Results are split
back per request.

Padding happens on the *row tensors*, after the pull (see
``ServingPlane``): padded rows are zeros, padded predictions are sliced
off before the split, and the serve cache never sees a padding id.

Admission control (the serving twin of the train pipeline's sync-lag
backpressure): an :class:`AdmissionConfig` bounds the pending queue and
stamps every ticket with an arrival time from an injectable clock.

* **Depth shedding** — when admitting a request would push the pending
  window past ``max_pending`` examples, the OLDEST live tickets are shed
  first (they are the stalest; their callers have waited longest and are
  the most likely to have timed out upstream anyway). The newest request
  is always admitted: load shedding protects the queue, it never blanks
  the current caller while older work is holding the depth.
* **Deadline shedding** — at ``flush`` time, tickets whose
  ``deadline`` (seconds since admit) has passed are shed instead of
  executed: work nobody is still waiting for must not consume the
  bucket budget of work somebody is.
* **Budgeted flush** — ``flush(budget=n)`` drains at most ``n``
  examples (oldest first) and leaves the rest pending, which is what
  turns the scheduler into a closed-loop queueing system: offered load
  beyond the service budget accumulates as queue depth, and the depth
  bound converts the overflow into counted sheds instead of unbounded
  p99. At least one request always executes per budgeted flush
  (progress guarantee for requests larger than the budget).

Shed tickets resolve to ``None`` in ``flush``'s ticket-ordered result
list; counters keep ``executed + shed == offered`` balanced per request
AND per example. Per-request queueing+service latency is recorded into a
shared :class:`~repro_torch.core.monitor.PercentileRing`, so the SLO harness,
the admission controller, and the domino-downgrade trigger all read one
percentile implementation.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.core.monitor import PercentileRing

# power-of-two ladder: worst-case padding is <50 % of a bucket, and the
# predict runs at most len(DEFAULT_BUCKETS) shapes — the
# trade a serving system wants (a sparse ladder like (64, 4096) would
# waste up to 63/64 of a bucket on mid-sized requests)
DEFAULT_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)


@dataclass
class SchedulerStats:
    requests: int = 0
    examples: int = 0
    padded_examples: int = 0        # zero-rows added to reach a bucket
    batches: int = 0                # bucket executions
    bucket_counts: dict = field(default_factory=dict)

    @property
    def padding_fraction(self) -> float:
        total = self.examples + self.padded_examples
        return self.padded_examples / total if total else 0.0


@dataclass
class AdmissionConfig:
    """Serve-path admission bounds. Both default to None = unbounded —
    the pre-admission behavior, and what every existing caller gets."""

    max_pending: Optional[int] = None   # pending-example depth bound
    deadline: Optional[float] = None    # seconds from admit to execution


@dataclass
class AdmissionStats:
    """Load-shed accounting. Invariant once the queue is drained:
    ``executed + shed == offered`` at request AND example granularity
    (``shed = shed_depth + shed_deadline``)."""

    offered_requests: int = 0
    offered_examples: int = 0
    executed_requests: int = 0
    executed_examples: int = 0
    shed_depth_requests: int = 0
    shed_depth_examples: int = 0
    shed_deadline_requests: int = 0
    shed_deadline_examples: int = 0

    @property
    def shed_requests(self) -> int:
        return self.shed_depth_requests + self.shed_deadline_requests

    @property
    def shed_examples(self) -> int:
        return self.shed_depth_examples + self.shed_deadline_examples

    def as_dict(self) -> dict:
        return {
            "offered_requests": self.offered_requests,
            "offered_examples": self.offered_examples,
            "executed_requests": self.executed_requests,
            "executed_examples": self.executed_examples,
            "shed_requests": self.shed_requests,
            "shed_examples": self.shed_examples,
            "shed_depth_requests": self.shed_depth_requests,
            "shed_deadline_requests": self.shed_deadline_requests,
        }


class _Ticket:
    """One admitted request waiting for a flush."""

    __slots__ = ("ids", "t_admit", "shed")

    def __init__(self, ids: np.ndarray, t_admit: float):
        self.ids = ids
        self.t_admit = t_admit
        self.shed: Optional[str] = None      # None | "depth" | "deadline"


class PredictScheduler:
    """Admit → (maybe shed) → coalesce → bucket → split for one
    scenario's predict fn."""

    def __init__(self, runner: Callable[[np.ndarray, int], np.ndarray],
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS, *,
                 admission: Optional[AdmissionConfig] = None,
                 clock: Optional[Callable[[], float]] = None,
                 latency_ring: Optional[PercentileRing] = None):
        assert buckets, "need at least one bucket size"
        self.runner = runner            # runner(ids (b, f), bucket) -> (b,)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.admission = admission or AdmissionConfig()
        self.clock = clock or time.perf_counter
        # queueing+service latency per executed request — shared percentile
        # machinery (core/monitor.py), readable by the downgrade trigger
        self.latency = latency_ring if latency_ring is not None \
            else PercentileRing(1 << 14)
        self._pending: deque[_Ticket] = deque()
        self._pending_examples = 0      # live (non-shed) queued examples
        self.stats = SchedulerStats()
        self.adm = AdmissionStats()

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    @property
    def pending_examples(self) -> int:
        """Live queue depth in examples (shed tickets excluded)."""
        return self._pending_examples

    def bucket_for(self, n: int) -> int:
        """Smallest bucket covering ``n``; the largest bucket for loads
        that exceed it (they run as multiple full buckets + one padded
        remainder)."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def submit(self, ids: np.ndarray) -> int:
        """Admit one request; returns its ticket for the next ``flush``.
        Over the depth bound, the OLDEST live tickets shed to make room
        (resolved as ``None`` results at their flush)."""
        ids = np.asarray(ids, dtype=np.int64)
        assert ids.ndim == 2, "predict requests are (batch, fields) ids"
        self.stats.requests += 1
        self.stats.examples += len(ids)
        self.adm.offered_requests += 1
        self.adm.offered_examples += len(ids)
        self._pending.append(_Ticket(ids, self.clock()))
        self._pending_examples += len(ids)
        cap = self.admission.max_pending
        if cap is not None and self._pending_examples > cap:
            self._shed_depth(cap)
        return len(self._pending) - 1

    def _shed_depth(self, cap: int) -> None:
        """Shed oldest-first until the live depth fits ``cap``. The
        newest ticket survives even if it alone exceeds the bound (depth
        shedding bounds *queueing*, it does not reject big requests)."""
        for tk in self._pending:
            if self._pending_examples <= cap:
                break
            if tk.shed is not None or tk is self._pending[-1]:
                continue
            tk.shed = "depth"
            self._pending_examples -= len(tk.ids)
            self.adm.shed_depth_requests += 1
            self.adm.shed_depth_examples += len(tk.ids)

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def flush(self, budget: Optional[int] = None) -> list:
        """Drain the pending window oldest-first as one coalesced load;
        returns per-request results in ticket order (``None`` for shed
        tickets). With ``budget``, at most that many examples execute
        (but always at least one request) and the remainder stays
        pending for the next flush — the queueing behavior the overload
        harness measures."""
        now = self.clock()
        dl = self.admission.deadline
        out: list = []                 # result slot per drained ticket
        run: list[_Ticket] = []        # tickets to execute this round
        spent = 0
        while self._pending:
            tk = self._pending[0]
            if tk.shed is None and dl is not None and now - tk.t_admit > dl:
                tk.shed = "deadline"
                self._pending_examples -= len(tk.ids)
                self.adm.shed_deadline_requests += 1
                self.adm.shed_deadline_examples += len(tk.ids)
            if tk.shed is not None:
                out.append(None)
                self._pending.popleft()
                continue
            if budget is not None and spent + len(tk.ids) > budget \
                    and spent > 0:
                break                  # budget exhausted; rest waits
            run.append(tk)
            out.append(tk)             # placeholder, filled below
            spent += len(tk.ids)
            self._pending_examples -= len(tk.ids)
            self._pending.popleft()
        if run:
            ids = run[0].ids if len(run) == 1 else \
                np.concatenate([tk.ids for tk in run], axis=0)
            preds = self._run(ids)
            bounds = np.cumsum([len(tk.ids) for tk in run])[:-1]
            parts = np.split(preds, bounds)
            done = self.clock()
            k = 0
            for i, slot in enumerate(out):
                if slot is None:
                    continue
                out[i] = parts[k]
                k += 1
            for tk in run:
                self.latency.record(done - tk.t_admit)
                self.adm.executed_requests += 1
                self.adm.executed_examples += len(tk.ids)
        return out

    def run_one(self, ids: np.ndarray) -> np.ndarray:
        """Immediate single-request path: bucketed execution of ``ids``
        alone, no admission (the caller is synchronous — there is no
        queue to protect). Requests admitted via ``submit`` stay pending
        — their results belong to the next ``flush``, never to this
        call."""
        ids = np.asarray(ids, dtype=np.int64)
        assert ids.ndim == 2, "predict requests are (batch, fields) ids"
        self.stats.requests += 1
        self.stats.examples += len(ids)
        self.adm.offered_requests += 1
        self.adm.offered_examples += len(ids)
        t0 = self.clock()
        out = self._run(ids)
        self.latency.record(self.clock() - t0)
        self.adm.executed_requests += 1
        self.adm.executed_examples += len(ids)
        return out

    def register_metrics(self, reg, prefix: str = "scheduler") -> None:
        """Publish this scheduler's admission/latency/batching counters
        into a ``repro_torch.obs.metrics.MetricsRegistry``."""
        from repro_torch.obs.metrics import join
        reg.register(join(prefix, "admission"), self.adm.as_dict)
        reg.register(join(prefix, "latency"),
                     lambda: self.latency.percentiles((50, 99)))
        reg.register(join(prefix, "batches"), lambda: self.stats.batches)
        reg.register(join(prefix, "padding_fraction"),
                     lambda: self.stats.padding_fraction)
        reg.register(join(prefix, "pending_examples"),
                     lambda: self.pending_examples)

    def _run(self, ids: np.ndarray) -> np.ndarray:
        total = len(ids)
        out = np.empty(total, np.float32)
        pos = 0
        while pos < total:
            bucket = self.bucket_for(total - pos)
            take = min(total - pos, bucket)
            out[pos:pos + take] = self.runner(ids[pos:pos + take], bucket)
            self.stats.batches += 1
            self.stats.padded_examples += bucket - take
            self.stats.bucket_counts[bucket] = \
                self.stats.bucket_counts.get(bucket, 0) + 1
            pos += take
        return out
