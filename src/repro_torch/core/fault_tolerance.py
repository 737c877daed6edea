"""Hot backup for the serving plane: ``ReplicaSet`` (paper §4.2.2).

Checkpoints, the cold-backup plane and recovery routing wait for their
slice of the port; this module holds only the replica set the serving
plane reads through.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.core.ps import SlaveShard


class ReplicaSet:
    """Hot backup (§4.2.2): multi-replica load balancing over slave shards
    holding the same shard_id. Stateless LB + stateful replicas.

    The serving plane attaches each replica's stream consumer so selection
    can enforce a staleness bound: a replica whose consumer offsets trail
    the push head by more than ``max_lag`` records is skipped while a
    fresher healthy replica exists (availability still wins — when every
    replica exceeds the bound, the freshest one serves)."""

    def __init__(self, replicas: list[SlaveShard],
                 bootstrap: Optional[Callable[[SlaveShard],
                                              Optional[dict]]] = None):
        if not replicas:
            raise ValueError("a replica set needs at least one replica")
        self.replicas = replicas
        self.bootstrap = bootstrap
        self._rr = 0
        self._scatters: dict[int, object] = {}    # id(shard) -> consumer
        self.failovers = 0
        self.lag_skips = 0

    def healthy(self) -> list[SlaveShard]:
        return [r for r in self.replicas if r.alive]

    def attach_scatter(self, shard: SlaveShard, scatter) -> None:
        """Register the consumer feeding ``shard`` — anything with a
        ``lag()`` in records; its lag is the staleness signal."""
        self._scatters[id(shard)] = scatter

    def replica_lag(self, shard: SlaveShard) -> int:
        """Records produced to this shard's partitions not yet applied
        (0 when no consumer is attached — nothing to lag behind)."""
        sc = self._scatters.get(id(shard))
        return sc.lag() if sc is not None else 0

    def pick(self, max_lag: Optional[int] = None) -> SlaveShard:
        """Round-robin over healthy replicas; failover transparently.
        With ``max_lag`` set, replicas over the staleness bound are
        skipped unless no healthy replica is within it."""
        h = self.healthy()
        if not h:
            raise RuntimeError("all replicas down")
        if max_lag is not None and len(h) > 1:
            lags = [self.replica_lag(r) for r in h]
            fresh = [r for r, lag in zip(h, lags) if lag <= max_lag]
            if fresh and len(fresh) < len(h):
                self.lag_skips += len(h) - len(fresh)
                h = fresh
            elif not fresh:
                h = [h[int(np.argmin(lags))]]
        r = h[self._rr % len(h)]
        self._rr += 1
        return r

    def read(self, fn: Callable[[SlaveShard], "np.ndarray"], *,
             max_lag: Optional[int] = None):
        """Serving read with failover retry — the request never fails
        while any replica lives. Only ``AssertionError`` (a dead replica,
        see ``SlaveShard.lookup``) fails over; other errors propagate."""
        for _ in range(len(self.replicas)):
            r = self.pick(max_lag=max_lag)
            try:
                return fn(r)
            except AssertionError:
                self.failovers += 1
                continue
        raise RuntimeError("all replicas down")

    def lookup(self, group: str, ids: np.ndarray,
               max_lag: Optional[int] = None) -> np.ndarray:
        return self.read(lambda r: r.lookup(group, ids), max_lag=max_lag)

    def add_replica(self, shard: SlaveShard, *,
                    bootstrap: Optional[Callable] = None) -> Optional[dict]:
        """Grow the set. With a ``bootstrap`` fn (per call or set on the
        replica set) the fn installs serve state and returns queue offsets
        for the caller; otherwise the new replica copies a healthy peer
        (returns None)."""
        fn = bootstrap if bootstrap is not None else self.bootstrap
        offsets = fn(shard) if fn is not None else None
        if offsets is None:
            shard.full_sync_from(self.healthy()[0])
        self.replicas.append(shard)
        return offsets
