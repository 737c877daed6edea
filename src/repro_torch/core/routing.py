"""Shard routing: ID → master shard / queue partition / slave shard.

The paper's *model routing* requirement (§4.1.4a): master and slave shard
counts differ (training is throughput-sharded, serving is latency/QPS-
sharded), and the same stream must serve both. We partition the queue by
**ID** (not by producer shard): with ``num_partitions`` a multiple of the
slave shard count, partition ``p`` only ever contains IDs owned by slave
shard ``p % num_slave`` — each slave consumes exactly its partitions, no
filtering waste (paper: "the slave can specify certain partitions for
consuming ... reducing bandwidth pressure").

The same plan drives checkpoint-reload migration across heterogeneous
clusters (paper §4.2.1d): ``reshard_plan`` maps every source shard's rows to
destination shards.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _mix(ids: np.ndarray) -> np.ndarray:
    """Cheap deterministic 64-bit mix so modulo sharding is balanced even
    for structured ID spaces (e.g. contiguous feature buckets)."""
    x = ids.astype(np.uint64, copy=True)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    return x


@dataclass(frozen=True)
class RoutingPlan:
    num_master: int
    num_slave: int
    num_partitions: int

    def __post_init__(self):
        assert self.num_master >= 1 and self.num_slave >= 1
        assert self.num_partitions % self.num_slave == 0, (
            "num_partitions must be a multiple of num_slave so each slave "
            "shard consumes exactly its own partitions")

    def master_shard(self, ids: np.ndarray) -> np.ndarray:
        return (_mix(np.asarray(ids)) % np.uint64(self.num_master)).astype(
            np.int64)

    def partition(self, ids: np.ndarray) -> np.ndarray:
        return (_mix(np.asarray(ids)) % np.uint64(self.num_partitions)).astype(
            np.int64)

    def slave_shard(self, ids: np.ndarray) -> np.ndarray:
        # congruent with partition(): id -> partition p has p % S == slave
        return (self.partition(ids) % self.num_slave).astype(np.int64)

    def partitions_for_slave(self, slave_id: int) -> list[int]:
        return [p for p in range(self.num_partitions)
                if p % self.num_slave == slave_id]

    def split_by_master(self, ids: np.ndarray) -> dict[int, np.ndarray]:
        owner = self.master_shard(ids)
        return {s: ids[owner == s] for s in range(self.num_master)
                if np.any(owner == s)}

    def split_by_partition(self, ids: np.ndarray) -> dict[int, np.ndarray]:
        part = self.partition(ids)
        return {p: ids[part == p] for p in np.unique(part)}


def owner_segments(owner: np.ndarray):
    """Yield (owner_id, index array) per destination with ONE argsort over
    the whole id set — the segment-routing primitive shared by the
    streaming pusher (ids → queue partitions), the recovery router
    (checkpoint rows → shards), and the serving pull path (request ids →
    slave shards / master shards). Callers apply the yielded indices to
    whatever columns they route."""
    key = owner
    if key.size and key.itemsize > 2 and 0 <= key[0] < 65536 \
            and int(key.max()) < 65536 and int(key.min()) >= 0:
        # shard/partition ids are tiny: radix-sorting uint16 keys is 2
        # byte-passes where int64 keys cost 8 — this argsort is the bulk
        # of segment routing on 64k-id cold pulls
        key = key.astype(np.uint16)
    order = np.argsort(key, kind="stable")
    sorted_owner = owner.take(order, mode="clip")
    seg = np.flatnonzero(np.diff(sorted_owner)) + 1
    starts = np.concatenate(([0], seg))
    ends = np.concatenate((seg, [len(owner)]))
    for s, e in zip(starts, ends):
        yield int(sorted_owner[s]), order[s:e]


def reshard_plan(ids: np.ndarray, src_shards: int,
                 dst_shards: int) -> dict[tuple[int, int], np.ndarray]:
    """Checkpoint migration: {(src, dst): ids} mapping for loading a
    checkpoint written with ``src_shards`` into a ``dst_shards`` cluster."""
    ids = np.asarray(ids)
    src = (_mix(ids) % np.uint64(src_shards)).astype(np.int64)
    dst = (_mix(ids) % np.uint64(dst_shards)).astype(np.int64)
    out: dict[tuple[int, int], np.ndarray] = {}
    for s in np.unique(src):
        mask_s = src == s
        for d in np.unique(dst[mask_s]):
            out[(int(s), int(d))] = ids[mask_s & (dst == d)]
    return out
