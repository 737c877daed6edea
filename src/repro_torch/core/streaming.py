"""Streaming synchronization (paper §4.1): collect → gather → push → scatter
— counterpart of the reference's ``core/streaming.py``.

  Collector  — per master shard; captures dirty ids + op type only (no
               values, no increments).
  Gatherer   — deduplicating aggregation window with the paper's three
               trigger modes: real-time, threshold-based, period-based.
  Pusher     — reads *current full values* for the gathered ids (eventual
               consistency at id granularity: never increments), applies
               the model transform (FTRL z,n→w, dtype cast, int8 quant —
               the ``quantize_rows`` kernel under the torch codec backend),
               and produces to the id-routed queue partition.
  Scatter    — per slave shard; consumes its partitions and applies records
               idempotently (LWW by seq; int8 decode through the
               ``dequantize_rows`` kernel under the torch codec backend).

The push and scatter stages are batched: one gather + one encode per
(group, op), vectorized argsort routing to partitions, and one ownership
filter + one coalesced scatter per poll.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.monitor import PercentileRing
from repro_torch.core.ps import MasterShard, SlaveShard
from repro_torch.core.queue import Consumer, PartitionedQueue, Record
from repro_torch.core.routing import RoutingPlan
from repro_torch.core.transform import Transform
from repro_torch.obs import trace as obs_trace


class Collector:
    """Dirty-id capture: ids + op only, never values (§4.1.1)."""

    def __init__(self):
        self._events: list[tuple[str, np.ndarray, str]] = []
        self.collected_ids = 0

    def record(self, group: str, ids: np.ndarray, op: str = "upsert") -> None:
        ids = np.asarray(ids, dtype=np.int64)
        self._events.append((group, ids, op))
        self.collected_ids += len(ids)

    def record_dense(self, name: str) -> None:
        self._events.append((f"dense/{name}", np.zeros(1, np.int64), "upsert"))

    def drain(self) -> list[tuple[str, np.ndarray, str]]:
        out, self._events = self._events, []
        return out


@dataclass
class GatherStats:
    raw_ids: int = 0          # ids entering the window (with repetition)
    pushed_ids: int = 0       # unique ids actually pushed
    flushes: int = 0

    @property
    def dedup_ratio(self) -> float:
        """Fraction of raw updates absorbed by deduplication."""
        if self.raw_ids == 0:
            return 0.0
        return 1.0 - self.pushed_ids / self.raw_ids


class Gatherer:
    """Aggregation window with the three trigger modes (§4.1.2)."""

    def __init__(self, mode: str = "period", *, threshold: int = 4096,
                 period: float = 1.0):
        if mode not in ("realtime", "threshold", "period"):
            raise ValueError(f"unknown gather mode {mode!r}")
        self.mode = mode
        self.threshold = threshold
        self.period = period
        # window state: (group, op) -> list of per-offer unique id arrays,
        # merged once at flush
        self._pending: dict[tuple[str, str], list[np.ndarray]] = {}
        self._pending_count = 0      # pre-merge upper bound on unique ids
        self._last_flush = 0.0
        self.stats = GatherStats()

    def offer(self, events: list[tuple[str, np.ndarray, str]]) -> None:
        for group, ids, op in events:
            ids = np.asarray(ids, dtype=np.int64)
            self.stats.raw_ids += len(ids)
            u = np.unique(ids)
            self._pending.setdefault((group, op), []).append(u)
            # upper bound: cross-offer repeats collapse only at flush, so
            # threshold mode can fire slightly early — never late
            self._pending_count += len(u)

    def ready(self, now: float) -> bool:
        if self._pending_count == 0 and not self._pending:
            return False
        if self.mode == "realtime":
            return True
        if self.mode == "threshold":
            return self._pending_count >= self.threshold
        return (now - self._last_flush) >= self.period

    def flush(self, now: float) -> dict[tuple[str, str], np.ndarray]:
        out = {}
        for k, chunks in self._pending.items():
            merged = chunks[0] if len(chunks) == 1 else \
                np.unique(np.concatenate(chunks))
            if len(merged):
                out[k] = merged
        self._pending = {}
        self._pending_count = 0
        self._last_flush = now
        self.stats.pushed_ids += sum(len(v) for v in out.values())
        self.stats.flushes += 1
        return out


def _slice_payload(payload: dict, lo: int, hi: int, n: int) -> dict:
    """Row-slice every per-row array of an encoded payload (arrays whose
    leading dim is the row count ``n``); scalars/metadata pass through."""
    out = {}
    for k, v in payload.items():
        a = np.asarray(v)
        out[k] = a[lo:hi] if a.ndim >= 1 and a.shape[0] == n else v
    return out


class Pusher:
    """Master-side: full-current-value reads + transform + partitioned
    produce. ``seq`` is per (group, producer) monotonic.

    ONE ``table.gather`` and ONE ``transform.encode`` cover every id of a
    (group, op) flush; ids are then routed to partitions with a single
    argsort and the encoded payload is *sliced*, never re-encoded, per
    partition-chunk record."""

    def __init__(self, shard: MasterShard, queue: PartitionedQueue,
                 plan: RoutingPlan, transform: Transform,
                 max_ids_per_record: int = 65536):
        self.shard = shard
        self.queue = queue
        self.plan = plan
        self.transform = transform
        self.max_ids_per_record = max_ids_per_record
        self._seq: dict[str, int] = {}
        self.pushed_bytes = 0
        self.pushed_records = 0
        # trace metadata stamped into every record of the current flush
        # while a sync.push span is open (None when tracing is off, so
        # the disabled path produces byte-identical records)
        self._tmeta: Optional[dict] = None

    def _next_seq(self, group: str) -> int:
        s = self._seq.get(group, -1) + 1
        self._seq[group] = s
        return s

    def seqs(self) -> dict[str, int]:
        """Per-group sequence counters for a checkpoint cut."""
        return dict(self._seq)

    def restore_seqs(self, seqs: dict[str, int]) -> None:
        self._seq = dict(seqs)

    def push(self, gathered: dict[tuple[str, str], np.ndarray],
             now: float = 0.0) -> int:
        """Returns number of records produced."""
        tr = obs_trace.get_tracer()
        sp = None
        if tr.enabled and gathered:
            # one flush == one trace: every record produced below carries
            # this (trace, span, t_push), so the consumer can reconstruct
            # queue dwell and parent its apply under this span
            sp = tr.begin("sync.push", trace=tr.new_trace(),
                          producer=self.shard.shard_id,
                          groups=len(gathered))
            self._tmeta = {"trace": sp.trace, "span": sp.id,
                           "t_push": sp.t0}
        n_rec = 0
        try:
            for (group, op), ids in gathered.items():
                if group.startswith("dense/"):
                    n_rec += self._push_dense(group, op, now)
                else:
                    n_rec += self._push_sparse(group, op, ids, now)
        finally:
            if sp is not None:
                tr.end(sp)
                self._tmeta = None
        self.pushed_records += n_rec
        return n_rec

    def _push_dense(self, group: str, op: str, now: float) -> int:
        name = group[len("dense/"):]
        value = self.shard.dense.tensors.get(name)
        if value is None:
            return 0
        ver = self.shard.dense.versions[name]
        # copy: identity encode passes arrays through uncopied, and a
        # queued payload must never alias the live dense tensor
        payload = self.transform.encode(
            value.reshape(1, -1).copy(),
            self.shard.dense.slots.get(name, {}))
        meta = {"codec": self.transform.name, "t": now,
                "shape": value.shape}
        if self._tmeta is not None:
            meta.update(self._tmeta)
        rec = Record(group=group, op="upsert",
                     ids=np.array([ver], np.int64), payload=payload,
                     seq=self._next_seq(group),
                     producer=self.shard.shard_id, meta=meta)
        n = 0
        # dense tensors go to every slave: one partition per slave shard
        for slave in range(self.plan.num_slave):
            p = self.plan.partitions_for_slave(slave)[0]
            self.queue.produce(p, rec)
            self.pushed_bytes += rec.nbytes()
            n += 1
        return n

    def _push_sparse(self, group: str, op: str, ids: np.ndarray,
                     now: float) -> int:
        if len(ids) == 0:
            return 0
        table = self.shard.tables[group]
        seq = self._next_seq(group)
        # vectorized routing: one argsort groups ids into contiguous
        # partition segments
        part = self.plan.partition(ids)
        order = np.argsort(part, kind="stable")
        ids = ids.take(order, mode="clip")
        part = part.take(order, mode="clip")
        seg = np.flatnonzero(np.diff(part)) + 1      # segment boundaries
        starts = np.concatenate(([0], seg))
        ends = np.concatenate((seg, [len(ids)]))
        if op == "delete":
            payload = None
        else:
            # ONE batched gather of only the columns the transform reads
            # (FTRL codecs read (z, n) and skip w), then ONE encode
            w, slots = table.gather(
                ids, want_w=self.transform.requires_w,
                slot_names=self.transform.required_slots)
            payload = self.transform.encode(w, slots)
        n = 0
        for s, e in zip(starts, ends):
            p = int(part[s])
            recs = []
            for i in range(s, e, self.max_ids_per_record):
                j = min(i + self.max_ids_per_record, e)
                # partition stamp: each partition is its own ordered
                # stream, so slaves key LWW staleness per (group,
                # producer, partition)
                meta = {"codec": self.transform.name, "t": now,
                        "partition": p}
                if self._tmeta is not None:
                    meta.update(self._tmeta)
                recs.append(Record(
                    group=group, op=op, ids=ids[i:j],
                    payload={} if payload is None
                    else _slice_payload(payload, i, j, len(ids)),
                    seq=seq, producer=self.shard.shard_id, meta=meta))
            self.queue.produce_many(p, recs)
            self.pushed_bytes += sum(r.nbytes() for r in recs)
            n += len(recs)
        return n


class Scatter:
    """Slave-side consumer: poll partitions, apply idempotently.

    A poll is batched: ownership of every sparse id in the poll is
    resolved with ONE vectorized routing pass, then the surviving records
    go through ``SlaveShard.apply_batch``."""

    def __init__(self, shard: SlaveShard, queue: PartitionedQueue,
                 plan: RoutingPlan,
                 offsets: Optional[dict[int, int]] = None):
        self.shard = shard
        self.plan = plan
        self.consumer = Consumer(queue, plan.partitions_for_slave(
            shard.shard_id), offsets)
        self.applied = 0
        self.last_record_time = 0.0
        # event→deployed staleness per applied record: the pusher stamps
        # meta["t"], the apply (with SlaveShard.on_apply's cache
        # invalidation) runs here, so now - meta["t"] is
        # push→scatter→cache-visible
        self.staleness = PercentileRing(1 << 12)
        # called with the polled records after the consumer advanced but
        # BEFORE any is applied — the crash window between fetch and apply
        self.pre_apply = None

    def poll(self, max_records: Optional[int] = None, *,
             now: Optional[float] = None) -> int:
        recs = self.consumer.poll(max_records)
        if not recs:
            return 0
        if self.pre_apply is not None:
            self.pre_apply(recs)
        # model routing: keep only ids owned by this slave shard — a no-op
        # for sparse groups when num_partitions % num_slave == 0, but it
        # guards re-partitioning. One vectorized pass covers the poll.
        sparse = [k for k, r in enumerate(recs)
                  if not r.group.startswith("dense/")]
        if sparse:
            owner = self.plan.slave_shard(
                np.concatenate([recs[k].ids for k in sparse]))
            keep_all = owner == self.shard.shard_id
            if not keep_all.all():
                off = 0
                for k in sparse:
                    r = recs[k]
                    keep = keep_all[off:off + len(r.ids)]
                    off += len(r.ids)
                    if not keep.all():
                        recs[k] = Record(
                            group=r.group, op=r.op, ids=r.ids[keep],
                            payload=_filter_payload(r.payload, keep),
                            seq=r.seq, producer=r.producer, meta=r.meta)
        tr = obs_trace.get_tracer()
        if tr.enabled:
            applied = self._apply_traced(tr, recs)
        else:
            applied = self.shard.apply_batch(recs)
        if applied:
            self.last_record_time = applied[-1].meta.get("t", 0.0)
            if now is not None:
                self.staleness.record(
                    [now - r.meta.get("t", now) for r in applied])
        self.applied += len(applied)
        return len(applied)

    def _apply_traced(self, tr, recs: list) -> list:
        """Trace-grouped apply: records stamped by one pusher flush (one
        trace id) apply together, so the flush shows as one queue-dwell +
        apply pair under its sync.push parent. Within a (group, producer,
        partition) stream records keep their order, and cross-trace
        overlap resolves by seq (LWW) as in arrival order."""
        by_trace: dict = {}
        for r in recs:
            by_trace.setdefault(r.meta.get("trace"), []).append(r)
        poll_t0 = tr.clock()
        applied: list = []
        for tid, group in by_trace.items():
            if tid is None:  # records produced before tracing turned on
                applied += self.shard.apply_batch(group)
                continue
            qid = tr.record(
                "sync.queue", trace=tid,
                parent=group[0].meta.get("span", 0),
                t0=min(r.meta.get("t_push", poll_t0) for r in group),
                t1=poll_t0, records=len(group))
            with tr.span("sync.apply", trace=tid, parent=qid,
                         shard=self.shard.shard_id, records=len(group)):
                applied += self.shard.apply_batch(group)
        return applied

    def offsets(self) -> dict[int, int]:
        return dict(self.consumer.offsets)

    def lag(self) -> int:
        """Records produced to this shard's partitions not yet applied —
        the staleness signal of lag-bounded replica selection."""
        return self.consumer.lag()

    def seek(self, offsets: dict[int, int]) -> None:
        """Rewind/forward this consumer to recorded queue offsets."""
        self.consumer.seek(offsets)


def _filter_payload(payload: dict, keep: np.ndarray) -> dict:
    out = {}
    for k, v in payload.items():
        v = np.asarray(v)
        out[k] = v[keep] if v.ndim >= 1 and v.shape[0] == len(keep) else v
    return out


@dataclass
class SyncMetrics:
    sync_lag_seconds: float = 0.0
    records_in_flight: int = 0
    dedup_ratio: float = 0.0
    pushed_bytes: int = 0


class SyncPipeline:
    """Wires one master shard's collect→gather→push and all slave scatters.

    ``tick(now)`` advances the pipeline; with mode="realtime" every tick
    flushes, with "period" flushes happen every ``period`` seconds."""

    def __init__(self, master: MasterShard, slaves: list[SlaveShard],
                 queue: PartitionedQueue, plan: RoutingPlan,
                 transform: Transform, gather_mode: str = "realtime",
                 threshold: int = 4096, period: float = 1.0):
        self.collector = Collector()
        master.collector = self.collector
        self.master = master
        self.gatherer = Gatherer(gather_mode, threshold=threshold,
                                 period=period)
        self.pusher = Pusher(master, queue, plan, transform)
        # the consumer-side codec backend is each SlaveShard's own
        # setting; the pipeline never overrides it
        self.scatters = [Scatter(s, queue, plan) for s in slaves]
        self.queue = queue

    def tick(self, now: float, *, scatter: bool = True) -> int:
        """collect+gather+maybe-push, then slave polls. Returns #records."""
        self.gatherer.offer(self.collector.drain())
        n = 0
        if self.gatherer.ready(now):
            n = self.pusher.push(self.gatherer.flush(now), now)
        if scatter:
            for sc in self.scatters:
                if sc.shard.alive:
                    sc.poll()
        return n

    def metrics(self, now: float) -> SyncMetrics:
        lag = max((now - sc.last_record_time) for sc in self.scatters) \
            if self.scatters else 0.0
        return SyncMetrics(
            sync_lag_seconds=lag,
            records_in_flight=sum(sc.consumer.lag() for sc in self.scatters),
            dedup_ratio=self.gatherer.stats.dedup_ratio,
            pushed_bytes=self.pusher.pushed_bytes,
        )
