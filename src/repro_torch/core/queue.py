"""Partitioned log — the stand-in for the paper's external Kafka queue
between master and slave parameter servers; counterpart of the
reference's ``core/queue.py`` (``FileQueue``, the durable transport of
the multi-process runtime, waits for the runtime slice).

Semantics kept faithful to what the paper relies on:
  * per-partition append ordering;
  * consumer-managed offsets (so a checkpointed offset can replay);
  * at-least-once delivery (records are idempotent: WeiPS pushes full
    current values per id, last-writer-wins by ``seq``);
  * partition-selective consumption (a slave subscribes only to its
    partitions — paper §4.1.4).
"""

from __future__ import annotations

import pickle
import threading
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional

import numpy as np


@dataclass
class Record:
    """One sync message: full current values for a set of ids of one group.

    ``seq`` is a per-(producer shard, group) monotonic version used for
    last-writer-wins idempotent application on the slave. ``op`` is
    "upsert" or "delete" (feature-filter expiry produces deletes).
    """

    group: str
    op: str
    ids: np.ndarray                  # (n,) int64 row/tensor ids
    payload: Any                     # transformed values (see transform.py)
    seq: int
    producer: int                    # master shard id
    meta: dict = field(default_factory=dict)
    _nbytes: Optional[int] = field(default=None, repr=False, compare=False)

    def nbytes(self) -> int:
        """Wire size estimate (bandwidth accounting), memoized. Codec
        payloads (dicts of arrays) are sized arithmetically; pickling them
        for accounting would copy the whole payload on the push hot
        path."""
        if self._nbytes is None:
            pay = 0
            try:
                if isinstance(self.payload, dict):
                    for v in self.payload.values():
                        pay += np.asarray(v).nbytes + 96   # ~pickle framing
                else:
                    pay = len(pickle.dumps(self.payload, protocol=4))
            except Exception:
                pay = 0
            self._nbytes = int(self.ids.nbytes + pay + 64)
        return self._nbytes


class PartitionedQueue:
    """In-memory partitioned log with per-partition offsets."""

    def __init__(self, num_partitions: int):
        if num_partitions < 1:
            raise ValueError(f"num_partitions must be >= 1, got "
                             f"{num_partitions}")
        self.num_partitions = num_partitions
        self._logs: list[list[Record]] = [[] for _ in range(num_partitions)]
        self._lock = threading.Lock()
        self.produced_bytes = 0
        self.produced_records = 0

    # -- producer side ---------------------------------------------------
    def produce(self, partition: int, record: Record) -> int:
        """Appends; returns the offset of the new record."""
        with self._lock:
            log = self._logs[partition]
            log.append(record)
            self.produced_bytes += record.nbytes()
            self.produced_records += 1
            return len(log) - 1

    def produce_many(self, partition: int, records: Iterable[Record]) -> int:
        """Batched append (one lock acquisition per partition segment).
        Returns the next offset after the appended records."""
        with self._lock:
            log = self._logs[partition]
            for record in records:
                log.append(record)
                self.produced_bytes += record.nbytes()
                self.produced_records += 1
            return len(log)

    # -- consumer side ----------------------------------------------------
    def consume(self, partition: int, offset: int,
                max_records: Optional[int] = None) -> tuple[list[Record], int]:
        """Reads records from ``offset``; returns (records, next_offset)."""
        log = self._logs[partition]
        end = len(log)
        if max_records is not None:
            end = min(end, offset + max_records)
        return log[offset:end], end

    def latest_offset(self, partition: int) -> int:
        return len(self._logs[partition])

    def latest_offsets(self) -> dict[int, int]:
        return {p: len(log) for p, log in enumerate(self._logs)}


class Consumer:
    """Offset-tracking consumer over a subset of partitions."""

    def __init__(self, queue: PartitionedQueue, partitions: Iterable[int],
                 offsets: Optional[dict[int, int]] = None):
        self.queue = queue
        self.partitions = sorted(set(partitions))
        self.offsets = {p: 0 for p in self.partitions}
        if offsets:
            self.offsets.update({p: offsets[p] for p in self.partitions
                                 if p in offsets})

    def poll(self, max_records: Optional[int] = None) -> list[Record]:
        out: list[Record] = []
        for p in self.partitions:
            recs, nxt = self.queue.consume(p, self.offsets[p], max_records)
            out.extend(recs)
            self.offsets[p] = nxt
        return out

    def lag(self) -> int:
        return sum(self.queue.latest_offset(p) - self.offsets[p]
                   for p in self.partitions)

    def seek(self, offsets: dict[int, int]) -> None:
        """Rewind/forward to recorded offsets (checkpoint replay)."""
        for p in self.partitions:
            if p in offsets:
                self.offsets[p] = offsets[p]
