"""Carry serve state across into the port.

Until the port has its own sync stream, serving replicas get their rows
installed in bulk: ``load_serve_state`` takes the columnar serve state
the JAX package produces (``WeiPSCluster._serve_state()["groups"]``, or
a ``SparseTable.snapshot()``'s ``ids``/``w`` per group) as plain NumPy,
routes each group's rows to the slave shards that own them with one
argsort pass, writes them into every replica of those shards, and
installs the dense bank — the way the reference cluster rebuilds its
replicas from a checkpoint (``WeiPSCluster._load_serve_rows`` and
``_apply_dense_state``). Tests use it to make both packages serve
identical state; ``chip_smoke.py`` uses it to load seeded rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.routing import RoutingPlan, owner_segments


def load_serve_state(replica_sets: list, plan: RoutingPlan,
                     groups: dict[str, tuple[np.ndarray, np.ndarray]],
                     dense: Optional[dict[str, np.ndarray]] = None,
                     dense_versions: Optional[dict[str, int]] = None
                     ) -> None:
    """Install serve rows and dense tensors on every replica.

    Args:
      replica_sets: the serving plane's ``ReplicaSet`` list.
      plan: the routing plan that assigns ids to slave shards.
      groups: ``{group: (ids int64 (N,), rows float32 (N, dim))}``, ids
        unique within a group.
      dense: ``{name: ndarray}`` dense tensors (a DNN's MLP), stored
        flattened as the slave stores streamed dense records.
      dense_versions: ``{name: version}``; 0 for names not given.
    """
    replicas = [shard for rs in replica_sets for shard in rs.replicas]
    by_sid: dict[int, list] = {}
    for shard in replicas:
        by_sid.setdefault(shard.shard_id, []).append(shard)
    for g, (ids, rows) in groups.items():
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if ids.ndim != 1 or rows.ndim != 2 or len(rows) != len(ids):
            raise ValueError(f"group {g!r}: ids {ids.shape} and rows "
                             f"{rows.shape} are not (N,) and (N, dim)")
        if not len(ids):
            continue
        for sid, idx in owner_segments(plan.slave_shard(ids)):
            seg_ids = ids.take(idx, mode="clip")
            seg_rows = rows.take(idx, axis=0, mode="clip")
            for shard in by_sid.get(sid, ()):
                shard.tables[g].scatter(seg_ids, seg_rows)
    for shard in replicas:
        for name, t in (dense or {}).items():
            shard.dense[name] = np.asarray(t, np.float32).reshape(1, -1)
            shard.dense_versions[name] = (dense_versions or {}).get(name, 0)
