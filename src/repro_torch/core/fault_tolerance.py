"""Multi-level fault tolerance (paper §4.2) — counterpart of the
reference's ``core/fault_tolerance.py``.

Cold backup (master): an incremental checkpoint/recovery plane —
  a) random-trigger scheduling (jittered cadence, drawn from the same
     ``random.Random`` sequence as the reference, so versions and kinds
     line up with it); saves are synchronous and in-process,
  b) hierarchical storage — frequent LOCAL tier, infrequent REMOTE tier
     (``CheckpointStore``); local-tier evictions past the retention
     window are *demoted* to the remote tier, never silently lost,
  c) full + delta checkpoints: the remote cadence writes full columnar
     snapshots, the local cadence writes deltas holding only the rows
     written since the previous checkpoint (``SparseTable`` mutation
     clock) plus evicted ids; restore folds full+deltas back together
     (``ColdBackup.materialize``), bit-equal to a full restore,
  d) queue offsets embedded in every checkpoint (streaming replay resumes
     exactly),
  e) dynamic routing on load — a checkpoint written by N shards loads
     into M shards with one argsort ownership pass (reshard migration),
  f) partial recovery — restore one crashed shard while the rest serve,
  g) optional int8 payload compression through the row codec
     (``BackupPolicy.compress="int8"``). ``codec_backend="torch"`` runs
     the ``quantize_rows`` / ``dequantize_rows`` kernels on ``device``
     (their plain versions on ``"cpu"``); ``"numpy"`` is the host codec.
     Both give the same bits.

Hot backup (slave): multi-replica sets with failover routing; a fresh
replica bootstraps from checkpoint-restore + streaming catch-up when a
checkpoint plane is wired (``ReplicaSet.add_replica(bootstrap=...)``),
falling back to a full copy from a healthy peer.

The checkpoint wire format is the reference's: plain dicts of NumPy
arrays (``convert.load_checkpoint`` carries a reference checkpoint over).
Where the reference asserts, this module raises ``RuntimeError`` or
``ValueError``.
"""

from __future__ import annotations

import logging
import os
import pickle
import random
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.core.ps import (DenseBank, MasterShard, SlaveShard,
                                 _upload, resolve_device)
from repro_torch.core.routing import owner_segments
from repro_torch.core.transform import Int8Transform, _check_backend
from repro_torch.kernels import ops

logger = logging.getLogger(__name__)

_ROW_KEYS = ("ids", "w", "last_touch", "touch_count")


@dataclass
class Checkpoint:
    version: int
    created_at: float
    shard_snaps: dict[int, dict]          # shard_id -> snapshot
    queue_offsets: dict[int, int]         # partition -> offset at save time
    num_shards: int
    metrics: dict = field(default_factory=dict)
    tier: str = "local"
    kind: str = "full"                    # "full" | "delta"
    base: Optional[int] = None            # previous chain link (deltas)


def checkpoint_nbytes(ckpt: Checkpoint) -> int:
    """Payload size of a checkpoint: every NumPy array in its shard snaps
    (ids, rows, slots, touch stats, compressed blocks, dense tensors)."""

    def walk(obj) -> int:
        if isinstance(obj, np.ndarray):
            return obj.nbytes
        if isinstance(obj, dict):
            return sum(walk(v) for v in obj.values())
        return 0

    return sum(walk(s) for s in ckpt.shard_snaps.values())


# ---------------------------------------------------------------------------
# int8 checkpoint compression (the sync stream's row codec, reused)
# ---------------------------------------------------------------------------
def _pack_rows(a: np.ndarray, backend: str, device="cuda") -> dict:
    """(n, d) f32 -> {"q" int8 (n, d), "scale" f32 (n, 1)} with the
    streaming int8 codec's arithmetic (the same bits on either
    backend)."""
    _check_backend(backend)
    if backend == "torch" and a.size:
        q, s = ops.quantize_rows(_upload(
            np.asarray(a, dtype=np.float32), resolve_device(device)))
        return {"q": q.cpu().numpy(), "scale": s.cpu().numpy()}
    return Int8Transform._quantize_np(a)


def _unpack_rows(p: dict, backend: str, device="cuda") -> np.ndarray:
    return Int8Transform.decode(p, backend=backend, device=device)


def _compress_table_snap(tsnap: dict, backend: str, device="cuda") -> dict:
    out = dict(tsnap)
    out["codec"] = "int8"
    out["w"] = _pack_rows(tsnap["w"], backend, device)
    out["slots"] = {n: _pack_rows(v, backend, device)
                    for n, v in tsnap["slots"].items()}
    return out


def _table_rows(tsnap: dict, backend: str = "numpy", device="cuda") -> dict:
    """Raw columnar rows of a (possibly compressed) table snapshot."""
    rows = {k: tsnap[k] for k in _ROW_KEYS}
    rows["slots"] = tsnap["slots"]
    if "deleted" in tsnap:
        rows["deleted"] = tsnap["deleted"]
    if tsnap.get("codec") == "int8":
        rows["w"] = _unpack_rows(tsnap["w"], backend, device)
        rows["slots"] = {n: _unpack_rows(v, backend, device)
                         for n, v in tsnap["slots"].items()}
    return rows


# ---------------------------------------------------------------------------
# columnar row-set algebra (chain merge + ownership routing)
# ---------------------------------------------------------------------------
def _empty_rows(like: dict) -> dict:
    return {"ids": np.empty(0, np.int64),
            "w": np.empty((0,) + like["w"].shape[1:], like["w"].dtype),
            "slots": {n: np.empty((0,) + v.shape[1:], v.dtype)
                      for n, v in like["slots"].items()},
            "last_touch": np.empty(0, np.int64),
            "touch_count": np.empty(0, np.int64)}


def _take_rows(rows: dict, idx) -> dict:
    out = {k: rows[k][idx] for k in _ROW_KEYS}
    out["slots"] = {n: v[idx] for n, v in rows["slots"].items()}
    return out


def _concat_rows(parts: list[dict]) -> dict:
    if len(parts) == 1:
        return parts[0]
    out = {k: np.concatenate([p[k] for p in parts]) for k in _ROW_KEYS}
    out["slots"] = {n: np.concatenate([p["slots"][n] for p in parts])
                    for n in parts[0]["slots"]}
    return out


def _merge_rows(base: dict, delta: dict) -> dict:
    """Overlay a delta row set onto a base: deletes drop base rows, then
    delta rows override base rows id-wise (last writer wins). One
    vectorized pass — no per-id Python."""
    deleted = delta.get("deleted", np.empty(0, np.int64))
    if len(deleted):
        base = _take_rows(base, ~np.isin(base["ids"], deleted))
    if not len(delta["ids"]):
        return base
    if not len(base["ids"]):
        return {k: delta[k] for k in (*_ROW_KEYS, "slots")}
    cat_ids = np.concatenate([base["ids"], delta["ids"]])
    # last occurrence wins: unique over the reversed array finds, for
    # every id, its final position in concatenation order
    _, first_rev = np.unique(cat_ids[::-1], return_index=True)
    take = len(cat_ids) - 1 - first_rev
    merged = {k: np.concatenate([base[k], delta[k]]).take(take, axis=0)
              for k in _ROW_KEYS}
    merged["slots"] = {
        n: np.concatenate([base["slots"][n], delta["slots"][n]])
        .take(take, axis=0) for n in base["slots"]}
    return merged


def merge_dense(bank: dict, dense: dict) -> None:
    """Overlay a (possibly delta) dense snapshot onto an accumulating
    bank dict — newer version counters win per tensor."""
    for k, t in dense["tensors"].items():
        if dense["versions"][k] > bank["versions"].get(k, -1):
            bank["tensors"][k] = t
            if k in dense["slots"]:
                bank["slots"][k] = dense["slots"][k]
            bank["versions"][k] = dense["versions"][k]


def merge_shard_tables(shard_snaps: dict[int, dict]) -> dict[str, dict]:
    """Concatenate every shard's rows per group (ids are disjoint across
    shards) into one columnar row set — the input of ownership routing."""
    groups: dict[str, list[dict]] = {}
    for snap in shard_snaps.values():
        for g, rows in snap["tables"].items():
            if len(rows["ids"]):
                groups.setdefault(g, []).append(rows)
    return {g: _concat_rows(parts) for g, parts in groups.items()}


def iter_owner_segments(owner: np.ndarray):
    """Segment routing for recovery: one argsort over the whole set
    (``core.routing.owner_segments``)."""
    return owner_segments(owner)


def iter_owner_rows(rows: dict, owner: np.ndarray):
    """``iter_owner_segments`` applied to a columnar row set: yields
    (owner_id, rows_slice)."""
    for dst, idx in iter_owner_segments(owner):
        yield dst, _take_rows(rows, idx)


def fold_chain(links_shard_snaps, codec_backend: str = "torch",
               device="cuda") -> dict[int, dict]:
    """Fold a full+delta chain of per-shard snapshots (apply order: full
    first) into full-equivalent columnar state — deletes drop rows, delta
    rows override base rows, dense tensors merge by version counter.

    ``links_shard_snaps`` iterates ``{shard_id: snapshot}`` per chain
    link, each snapshot in the ``MasterShard.snapshot`` /
    ``delta_snapshot`` wire format (possibly int8-compressed, decoded
    with ``codec_backend`` on ``device``)."""
    snaps: dict[int, dict] = {}
    for link in links_shard_snaps:
        for sid, snap in link.items():
            tables = {g: _table_rows(t, codec_backend, device)
                      for g, t in snap["tables"].items()}
            cur = snaps.get(sid)
            if cur is None:
                cur = {"shard_id": sid, "step": snap["step"],
                       "tables": {g: _merge_rows(_empty_rows(r), r)
                                  for g, r in tables.items()},
                       "dense": {"tensors": {}, "slots": {},
                                 "versions": {}}}
                snaps[sid] = cur
            else:
                cur["step"] = snap["step"]
                for g, rows in tables.items():
                    cur["tables"][g] = _merge_rows(
                        cur["tables"].get(g) or _empty_rows(rows), rows)
            dense = snap.get("dense")
            if dense:
                merge_dense(cur["dense"], dense)
    return snaps


class CheckpointStore:
    """Two-tier checkpoint storage. The local tier is in-memory (stands in
    for local disk); the remote tier pickles to files under ``root`` —
    slower, durable, written at a longer interval (paper §4.2.1b).

    Retention: at most ``keep`` checkpoints stay in the local tier. An
    evicted local-only checkpoint is *demoted* to the remote tier when a
    ``root`` is configured (so delta chains stay loadable); without a
    root it is log-dropped and recorded in ``dropped``, and any retained
    delta whose chain ran through the dropped link is cascade-dropped
    with it. ``versions()`` therefore always lists what ``load`` and
    ``materialize`` can serve."""

    def __init__(self, root: Optional[str] = None, keep: int = 8):
        self.root = root
        self.keep = keep
        self._local: dict[int, Checkpoint] = {}
        self._remote: dict[int, str] = {}
        # version -> base link (None for fulls), kept for every version
        # ever saved so chain integrity is checkable without loading
        self._base: dict[int, Optional[int]] = {}
        self.dropped: list[int] = []
        if root:
            os.makedirs(root, exist_ok=True)

    def _write_remote(self, ckpt: Checkpoint) -> None:
        path = os.path.join(self.root, f"ckpt_{ckpt.version}.pkl")
        with open(path, "wb") as f:
            pickle.dump(ckpt, f, protocol=4)
        self._remote[ckpt.version] = path

    def chain_intact(self, version: int) -> bool:
        """True when every link from ``version`` back to its full base is
        still loadable (metadata walk — no checkpoint loads)."""
        v: Optional[int] = version
        while v is not None:
            if v not in self._local and v not in self._remote:
                return False
            v = self._base.get(v)
        return True

    def chain_depth(self, version: int) -> int:
        """Links from ``version`` back to (and including) its full base."""
        d, v = 0, version
        while v is not None:
            d += 1
            v = self._base.get(v)
        return d

    def _drop(self, version: int, why: str) -> None:
        self._local.pop(version, None)
        self.dropped.append(version)
        logger.warning("checkpoint v%d dropped by local retention (%s)",
                       version, why)

    def save(self, ckpt: Checkpoint, tier: str = "local") -> None:
        ckpt.tier = tier
        self._local[ckpt.version] = ckpt
        self._base[ckpt.version] = ckpt.base
        if tier == "remote" and self.root:
            self._write_remote(ckpt)
        # retention: evict oldest local entries past the window
        while len(self._local) > self.keep:
            oldest = min(self._local)
            evicted = self._local.pop(oldest)
            if oldest in self._remote:
                continue                         # still served from remote
            if self.root:                        # demote instead of losing
                evicted.tier = "remote"
                self._write_remote(evicted)
                continue
            self.dropped.append(oldest)
            logger.warning(
                "checkpoint v%d dropped by local retention (no remote "
                "root configured)", oldest)
            # cascade: retained deltas that chained through the dropped
            # link are unrecoverable — drop them too
            for v in sorted(self._local):
                if not self.chain_intact(v):
                    self._drop(v, f"chain through dropped v{oldest}")

    def load(self, version: int) -> Checkpoint:
        if version in self._local:
            return self._local[version]
        if version in self._remote:
            with open(self._remote[version], "rb") as f:
                return pickle.load(f)
        raise KeyError(f"no checkpoint version {version}")

    def versions(self) -> list[int]:
        return sorted(set(self._local) | set(self._remote))

    def latest(self) -> Optional[int]:
        v = self.versions()
        return v[-1] if v else None


@dataclass
class BackupPolicy:
    """Per-model fault-tolerance strategy — hot-switchable (§4.2.1c)."""

    local_interval: float = 30.0          # < 1 hour in production
    remote_interval: float = 3600.0       # hour/day level
    jitter: float = 0.25                  # random trigger fraction
    incremental: bool = True              # local cadence writes deltas
    compress: str = "none"                # "none" | "int8" (row codec)


class ColdBackup:
    """Checkpoint scheduler + recovery for the master cluster.

    The remote cadence emits FULL columnar checkpoints; the local cadence
    emits DELTA checkpoints (dirty rows + evicted ids since the previous
    checkpoint) when ``policy.incremental`` — each delta records its
    ``base`` so restore can chain full+deltas back together. Any recovery
    forces the next checkpoint to be full (the restored tables start a
    fresh mutation clock). ``codec_backend`` and ``device`` run the int8
    compression and the chain's decode."""

    def __init__(self, shards: list[MasterShard], store: CheckpointStore,
                 policy: BackupPolicy, queue=None,
                 rng: Optional[random.Random] = None,
                 codec_backend: str = "torch", device="cuda"):
        _check_backend(codec_backend)
        if codec_backend == "torch":
            resolve_device(device)        # raise now, not at first save
        self.shards = shards
        self.store = store
        self.policy = policy
        self.queue = queue
        self.rng = rng or random.Random(0)
        self.codec_backend = codec_backend
        self.device = device
        self._version = 0
        self._next_local = self._jittered(0.0, policy.local_interval)
        self._next_remote = self._jittered(0.0, policy.remote_interval)
        # delta bookkeeping: per-shard {group: mutation clock} and
        # {dense name: version} at the previous checkpoint
        self._marks: dict[int, dict[str, int]] = {}
        self._dense_marks: dict[int, dict[str, int]] = {}
        self._last_version: Optional[int] = None
        self._force_full = True

    def _jittered(self, now: float, interval: float) -> float:
        j = 1.0 + self.rng.uniform(-self.policy.jitter, self.policy.jitter)
        return now + interval * j

    def maybe_checkpoint(self, now: float,
                         metrics: Optional[dict] = None) -> Optional[int]:
        tier = None
        if now >= self._next_remote:
            tier = "remote"
            self._next_remote = self._jittered(now,
                                               self.policy.remote_interval)
            self._next_local = self._jittered(now, self.policy.local_interval)
        elif now >= self._next_local:
            tier = "local"
            self._next_local = self._jittered(now, self.policy.local_interval)
        if tier is None:
            return None
        return self.checkpoint(now, tier=tier, metrics=metrics)

    def checkpoint(self, now: float, tier: str = "local",
                   metrics: Optional[dict] = None) -> int:
        # a delta needs its whole base chain still loadable — retention
        # may have dropped a link (no remote root), in which case the
        # cadence re-bases on a fresh full
        can_delta = (tier == "local" and self.policy.incremental
                     and self._last_version is not None
                     and not self._force_full
                     and self.store.chain_intact(self._last_version))
        if can_delta and self.store.root is None:
            # without a remote root a chain longer than the retention
            # window would evict its own base; re-base before that
            can_delta = (self.store.chain_depth(self._last_version) + 1
                         < self.store.keep)
        kind = "delta" if can_delta else "full"
        self._version += 1
        offsets = (self.queue.latest_offsets() if self.queue is not None
                   else {})
        snaps: dict[int, dict] = {}
        for s in self.shards:
            if not s.alive:
                continue
            if kind == "full":
                snaps[s.shard_id] = s.snapshot()
            else:
                snaps[s.shard_id] = s.delta_snapshot(
                    self._marks.get(s.shard_id, {}),
                    self._dense_marks.get(s.shard_id, {}))
            # advance marks to the clocks captured in this snapshot, and
            # trim eviction-log entries the marks now cover
            self._marks[s.shard_id] = {
                g: t["version"] for g, t in snaps[s.shard_id]["tables"].items()}
            self._dense_marks[s.shard_id] = dict(s.dense.versions)
            for g, t in s.tables.items():
                t.trim_evict_log(self._marks[s.shard_id][g])
        if self.policy.compress == "int8":
            for snap in snaps.values():
                snap["tables"] = {
                    g: _compress_table_snap(t, self.codec_backend,
                                            self.device)
                    for g, t in snap["tables"].items()}
        ckpt = Checkpoint(
            version=self._version, created_at=now,
            shard_snaps=snaps,
            queue_offsets=offsets,
            num_shards=len(self.shards),
            metrics=dict(metrics or {}),
            kind=kind,
            base=self._last_version if kind == "delta" else None,
        )
        self.store.save(ckpt, tier=tier)
        self._last_version = self._version
        self._force_full = False
        return self._version

    # -- chain resolution --------------------------------------------------
    def chain(self, version: int) -> list[Checkpoint]:
        """The restore chain for ``version``: [full, delta, ..., delta]
        in apply order. Raises ``KeyError`` if retention dropped a link
        (configure a store root to demote instead)."""
        out = []
        v: Optional[int] = version
        while True:
            ckpt = self.store.load(v)
            out.append(ckpt)
            if ckpt.kind == "full":
                break
            if ckpt.base is None:
                raise RuntimeError(f"delta checkpoint v{ckpt.version} has "
                                   f"no base")
            v = ckpt.base
        return out[::-1]

    def materialize(self, version: Optional[int] = None) -> dict:
        """Resolve a checkpoint version into full-equivalent state:
        decompress payloads and fold the full+delta chain. Returns
        ``{version, created_at, queue_offsets, num_shards, shard_snaps}``
        where every shard snap holds plain columnar rows — the single
        input format of all recovery paths."""
        v = version if version is not None else self.store.latest()
        if v is None:
            raise RuntimeError("no checkpoint available")
        links = self.chain(v)
        snaps = fold_chain((c.shard_snaps for c in links),
                           self.codec_backend, self.device)
        tip = links[-1]
        return {"version": tip.version, "created_at": tip.created_at,
                "queue_offsets": tip.queue_offsets,
                "num_shards": tip.num_shards, "shard_snaps": snaps}

    # -- recovery ---------------------------------------------------------
    def recover_shard(self, shard: MasterShard,
                      version: Optional[int] = None) -> int:
        """Partial fault tolerance (§4.2.1e): restore ONE shard from the
        newest checkpoint (chaining deltas as needed); the rest of the
        cluster keeps serving."""
        state = self.materialize(version)
        shard.clear()
        snap = state["shard_snaps"].get(shard.shard_id)
        if snap is not None:
            shard.load_snapshot(snap)
        shard.alive = True
        self._force_full = True
        return state["version"]

    def recover_all(self, shards: list[MasterShard],
                    version: Optional[int] = None,
                    owner_of: Optional[Callable] = None) -> int:
        """Full recovery with dynamic routing (§4.2.1d): the checkpoint may
        have been written by a different shard count; ``owner_of(ids)``
        maps ids to the *new* shard layout. Routing is one argsort
        ownership pass over the merged columnar row set per group."""
        state = self.materialize(version)
        for s in shards:
            s.clear()
            s.alive = True
        self._force_full = True
        snaps = state["shard_snaps"]
        if owner_of is None and state["num_shards"] == len(shards):
            for s in shards:
                snap = snaps.get(s.shard_id)
                if snap is not None:
                    s.load_snapshot(snap)
            return state["version"]
        if owner_of is None:
            raise ValueError("shard count changed: recovery needs an "
                             "owner_of routing fn")
        step = max((s["step"] for s in snaps.values()), default=0)
        by_id = {s.shard_id: s for s in shards}
        for s in shards:
            s.step = step
        for g, rows in merge_shard_tables(snaps).items():
            owner = np.asarray(owner_of(rows["ids"]), dtype=np.int64)
            for dst, part in iter_owner_rows(rows, owner):
                by_id[dst].load_table_rows(g, part)
        # dense tensors live on shard 0 by convention (see WeiPSCluster)
        dense = {"tensors": {}, "slots": {}, "versions": {}}
        for snap in snaps.values():
            merge_dense(dense, snap["dense"])
        if dense["tensors"]:
            by_id.get(0, shards[0]).dense = DenseBank.restore(dense)
        return state["version"]


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
