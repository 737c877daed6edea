"""Partitioned log — the stand-in for the paper's external Kafka queue
between master and slave parameter servers; counterpart of the
reference's ``core/queue.py``: the in-memory ``PartitionedQueue`` and
the durable file-backed ``FileQueue`` with the same interface.

Semantics kept faithful to what the paper relies on:
  * per-partition append ordering;
  * consumer-managed offsets (so a checkpointed offset can replay);
  * at-least-once delivery (records are idempotent: WeiPS pushes full
    current values per id, last-writer-wins by ``seq``);
  * partition-selective consumption (a slave subscribes only to its
    partitions — paper §4.1.4).
"""

from __future__ import annotations

import fcntl
import json
import os
import pickle
import struct
import threading
import zlib
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

    def truncate_before(self, partition: int, offset: int) -> None:
        """Retention: offsets stay absolute (mark, don't free)."""
        del partition, offset


class FileQueue:
    """File-backed partitioned log with the :class:`PartitionedQueue`
    interface.

    One append-only file per partition holds CRC-framed pickled records::

        frame := header(8B: <II little-endian (body_len, crc32(body))) body

    Durability model:

      * Each frame is written with a single ``write(2)`` on an ``O_APPEND``
        fd under an exclusive ``flock``, so concurrent producers never
        interleave bytes of a frame on a local filesystem.
      * A producer killed mid-append leaves at most one torn frame at the
        tail. Readers validate length and CRC and stop at the first bad
        frame, so a torn tail reads as "not yet produced"; the next
        write-open truncates it under the lock.
      * Frames live in the page cache once ``write`` returns, so they
        survive process death without fsync.

    Offsets are record indices, identical to :class:`PartitionedQueue`'s,
    so checkpointed Scatter offsets seek and replay unchanged. Every
    handle keeps its own lazy ``(file_pos, body_len)`` index per partition
    and finds frames other handles appended by rescanning the tail.
    Frames pickle this package's ``Record``: a log written by another
    package holds other class paths and is not read here.
    """

    _HDR = struct.Struct("<II")

    def __init__(self, root: str, num_partitions: Optional[int] = None):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        meta_path = os.path.join(self.root, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                existing = json.load(f)["num_partitions"]
            if num_partitions not in (None, existing):
                raise ValueError(f"queue at {root} has {existing} "
                                 f"partitions, asked for {num_partitions}")
            num_partitions = existing
        else:
            if num_partitions is None or num_partitions < 1:
                raise ValueError(f"a new queue needs num_partitions >= 1, "
                                 f"got {num_partitions}")
            tmp = meta_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"num_partitions": num_partitions}, f)
            os.replace(tmp, meta_path)
        self.num_partitions = int(num_partitions)
        self._index: list[list[tuple[int, int]]] = \
            [[] for _ in range(self.num_partitions)]
        self._scanned: list[int] = [0] * self.num_partitions
        self._wfds: list[Optional[int]] = [None] * self.num_partitions
        self._rfds: list[Optional[int]] = [None] * self.num_partitions
        self._lock = threading.Lock()
        self.produced_bytes = 0          # this handle's contribution
        self.produced_records = 0

    def _path(self, partition: int) -> str:
        return os.path.join(self.root, f"part-{partition:05d}.log")

    def _wfd(self, partition: int) -> int:
        if self._wfds[partition] is None:
            fd = os.open(self._path(partition),
                         os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
            self._wfds[partition] = fd
            # tail repair under the append lock: live writers hold it
            # across their write, so a valid in-flight frame is never cut
            fcntl.flock(fd, fcntl.LOCK_EX)
            try:
                self._extend_index(partition)
                if os.fstat(fd).st_size > self._scanned[partition]:
                    os.ftruncate(fd, self._scanned[partition])
            finally:
                fcntl.flock(fd, fcntl.LOCK_UN)
        return self._wfds[partition]

    def _rfd(self, partition: int) -> int:
        if self._rfds[partition] is None:
            self._rfds[partition] = os.open(
                self._path(partition), os.O_RDONLY | os.O_CREAT, 0o644)
        return self._rfds[partition]

    def _extend_index(self, partition: int) -> None:
        """Index frames appended since the last scan; stop at a short or
        CRC-failing frame (a torn tail)."""
        fd = self._rfd(partition)
        size = os.fstat(fd).st_size
        pos = self._scanned[partition]
        index = self._index[partition]
        while pos + self._HDR.size <= size:
            hdr = os.pread(fd, self._HDR.size, pos)
            if len(hdr) < self._HDR.size:
                break
            body_len, crc = self._HDR.unpack(hdr)
            body_pos = pos + self._HDR.size
            if body_pos + body_len > size:
                break                                   # torn tail
            body = os.pread(fd, body_len, body_pos)
            if len(body) < body_len or zlib.crc32(body) != crc:
                break                                   # torn/corrupt tail
            index.append((body_pos, body_len))
            pos = body_pos + body_len
        self._scanned[partition] = pos

    # -- producer side ---------------------------------------------------
    def produce(self, partition: int, record: Record) -> int:
        return self.produce_many(partition, [record]) - 1

    def produce_many(self, partition: int, records: Iterable[Record]) -> int:
        """Appends one frame per record; returns the next offset (the
        record count this handle sees after the append)."""
        with self._lock:
            fd = self._wfd(partition)
            fcntl.flock(fd, fcntl.LOCK_EX)
            try:
                for record in records:
                    body = pickle.dumps(record, protocol=4)
                    os.write(fd, self._HDR.pack(len(body), zlib.crc32(body))
                             + body)
                    self.produced_bytes += record.nbytes()
                    self.produced_records += 1
            finally:
                fcntl.flock(fd, fcntl.LOCK_UN)
            self._extend_index(partition)
            return len(self._index[partition])

    # -- consumer side ----------------------------------------------------
    def consume(self, partition: int, offset: int,
                max_records: Optional[int] = None) -> tuple[list[Record], int]:
        with self._lock:
            self._extend_index(partition)
            index = self._index[partition]
            end = len(index)
            if max_records is not None:
                end = min(end, offset + max_records)
            fd = self._rfd(partition)
            out = [pickle.loads(os.pread(fd, length, pos))
                   for pos, length in index[offset:end]]
            # never rewind a consumer that seeked past a tail this handle
            # has not seen yet (recovering replicas do this)
            return out, end if out else max(end, offset)

    def latest_offset(self, partition: int) -> int:
        with self._lock:
            self._extend_index(partition)
            return len(self._index[partition])

    def latest_offsets(self) -> dict[int, int]:
        return {p: self.latest_offset(p) for p in range(self.num_partitions)}

    def truncate_before(self, partition: int, offset: int) -> None:
        """Retention: offsets stay absolute (mark, don't free)."""
        del partition, offset

    def close(self) -> None:
        with self._lock:
            for fds in (self._wfds, self._rfds):
                for i, fd in enumerate(fds):
                    if fd is not None:
                        os.close(fd)
                        fds[i] = None


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
