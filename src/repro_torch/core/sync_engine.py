"""ModelSyncEngine: the WeiPS streaming sync applied to a training LM —
second-level deployment of its state to a serving replica through the
partitioned queue; the counterpart of the reference's
``core/sync_engine.py``.

Granularity per parameter (the reference's rules):
  * ``embed``      — token-id rows (dirty = the unique tokens seen in the
                     gather window), or one dense tensor when the
                     embedding is tied to the LM head, whose CE gradient
                     is dense over the vocabulary;
  * everything else — tensor granularity with version counters (every
                     train step bumps them; the gather window dedups).

Leaves are named and ordered as the reference's ``_path_str`` over JAX's
flatten (``core.tree``: dict keys sorted), so seq numbers, partitions
(``leaf index % num_partitions``) and records match the reference's
record for record. ``tick`` reads each dirty leaf to host float32, as
the reference does; the codecs and the replica's state are NumPy.

Backends: ``SyncConfig.codec_backend`` ``"numpy" | "torch"`` with a
``device`` (``core.transform.CODEC_BACKENDS``): under ``torch`` the int8
codec runs the ``quantize_rows`` / ``dequantize_rows`` kernels on the
device (their plain versions on ``device="cpu"``); identity and cast16
stay NumPy. A dense leaf is ONE codec row, as in the reference.

Not ported: MoE expert-granular sync (no MoE model is ported; a config
with experts raises ``NotImplementedError``). Deliberate difference: the
pusher keeps its last-pushed shadow of a dense leaf only when
``delta_threshold`` is on, the one case that reads it (the reference
copies every pushed leaf).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree
from repro_torch.core.ps import resolve_device
from repro_torch.core.queue import Consumer, PartitionedQueue, Record
from repro_torch.core.streaming import Gatherer
from repro_torch.core.transform import decode_record, make_transform

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _host_f32(leaf, copy: bool = False) -> np.ndarray:
    """A param leaf as a host float32 array: a tensor is copied off its
    device in its own dtype, then widened on the host (exact for
    bfloat16, half the bytes over the bus). ``copy`` guarantees the
    result shares no memory with ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        out = leaf.detach().cpu().float()
        if copy and out.data_ptr() == leaf.data_ptr():
            out = out.clone()
        return out.numpy()
    return np.array(leaf, dtype=np.float32, copy=copy)


@dataclass
class SyncConfig:
    num_partitions: int = 8
    num_slaves: int = 1
    gather_mode: str = "period"
    period: float = 1.0
    threshold: int = 1 << 20
    codec: str = "cast16"
    codec_backend: str = "torch"      # numpy | torch (delta_codec kernels)
    device: str = "cuda"              # where the torch codec backend runs
    delta_threshold: float = 0.0      # 0 = push every dirty item
    full_refresh_every: int = 0       # flushes between forced full pushes
    embed_row_chunk: int = 65536
    # "window": dirty embed rows = tokens in the gather window (exact for
    # momentum-free optimizers). "cumulative": Adam/Momentum keep moving
    # previously touched rows every step, so every touched row is dirty.
    embed_dirty: str = "auto"         # auto | window | cumulative


class ServeReplica:
    """Slave-side full-model state: applies stream records into host
    float32 arrays keyed by leaf path; ``device_params`` materializes the
    port's param dict from them."""

    def __init__(self, cfg: ModelConfig, params_like: dict,
                 bootstrap: bool = True, codec_backend: str = "torch",
                 device="cuda"):
        """``bootstrap`` performs the paper's full synchronization (replica
        attach = checkpoint copy); streaming covers deltas thereafter."""
        self.cfg = cfg
        self.codec_backend = codec_backend
        self.device = device
        self.structure = tree.map_like(lambda leaf: None, params_like)
        flat = tree.flatten_with_paths(params_like)
        self.paths = [p for p, _ in flat]
        self.host: dict[str, np.ndarray] = {
            path: (_host_f32(leaf, copy=True) if bootstrap
                   else np.zeros(tuple(leaf.shape), np.float32))
            for path, leaf in flat}
        self._applied_seq: dict[tuple[str, int], int] = {}
        self.applied = 0
        self.versions: dict[str, int] = {}

    def _decode(self, rec: Record) -> np.ndarray:
        return decode_record(rec, backend=self.codec_backend,
                             device=self.device)

    def apply(self, rec: Record) -> bool:
        key = (rec.group, rec.producer)
        if rec.seq < self._applied_seq.get(key, -1):    # strictly older only
            return False
        values = self._decode(rec)
        kind, path = rec.meta["kind"], rec.meta["path"]
        if kind == "dense":
            ver = int(rec.ids[0])
            if self.versions.get(path, -1) < ver:
                self.host[path] = values.reshape(self.host[path].shape)
                self.versions[path] = ver
        elif kind == "rows":                      # embed rows
            self.host[path][rec.ids] = values
        else:
            raise ValueError(f"record kind {kind!r} is not ported")
        self._applied_seq[key] = rec.seq
        self.applied += 1
        return True

    def apply_batch(self, recs: list) -> int:
        """A poll's worth of records: row records coalesced per path into
        ONE indexed write (arrival order kept, so overlapping ids resolve
        last-writer-wins as sequential ``apply`` would); dense records one
        by one. Returns the number of records applied."""
        applied = 0
        rows_by_path: dict[str, tuple[list, list]] = {}
        for rec in recs:
            if rec.meta.get("kind") == "rows":
                key = (rec.group, rec.producer)
                if rec.seq < self._applied_seq.get(key, -1):
                    continue
                ids_l, val_l = rows_by_path.setdefault(
                    rec.meta["path"], ([], []))
                ids_l.append(rec.ids)
                val_l.append(self._decode(rec))
                self._applied_seq[key] = rec.seq
                self.applied += 1
                applied += 1
            else:
                applied += int(self.apply(rec))
        for path, (ids_l, val_l) in rows_by_path.items():
            self.host[path][np.concatenate(ids_l)] = np.concatenate(val_l,
                                                                    axis=0)
        return applied

    def device_params(self, dtype: str = "bfloat16", device="cuda") -> dict:
        """The port's param dict from the replica's state, in ``dtype`` on
        ``device`` (default the card; raises without one)."""
        if dtype not in _DTYPES:
            raise ValueError(f"dtype {dtype!r} is not one of "
                             f"{sorted(_DTYPES)}")
        dev = resolve_device(device)
        leaves = [torch.from_numpy(self.host[p]).to(
            device=dev, dtype=_DTYPES[dtype], copy=True) for p in self.paths]
        return tree.unflatten_like(self.structure, leaves)

    def staleness(self, train_params: dict) -> float:
        """Max relative L2 distance to the training params over the
        leaves — the eventual-consistency measure the tests bound."""
        worst = 0.0
        for path, leaf in tree.flatten_with_paths(train_params):
            a = _host_f32(leaf)
            denom = max(float(np.linalg.norm(a)), 1e-9)
            worst = max(worst,
                        float(np.linalg.norm(a - self.host[path])) / denom)
        return worst


class ModelSyncEngine:
    """Master-side collect / gather / push plus the slave replicas, at
    full-model scale."""

    _MOMENTUM_OPTS = ("adam", "momentum")

    def __init__(self, cfg: ModelConfig, params: dict,
                 sync: Optional[SyncConfig] = None, queue=None):
        """``queue`` injects a transport with the ``PartitionedQueue``
        interface; by default the engine owns an in-memory queue."""
        if cfg.num_experts:
            raise NotImplementedError(f"{cfg.name}: expert-granular sync "
                                      f"of MoE layers is not ported yet")
        self.cfg = cfg
        self.sync = sync or SyncConfig()
        s = self.sync
        self._embed_mode = s.embed_dirty
        if self._embed_mode == "auto":
            self._embed_mode = ("cumulative" if cfg.optimizer in
                                self._MOMENTUM_OPTS else "window")
        self._embed_touched: set[int] = set()
        if queue is not None and queue.num_partitions != s.num_partitions:
            raise ValueError("injected queue partition count must match "
                             "SyncConfig")
        self.queue = queue if queue is not None else \
            PartitionedQueue(s.num_partitions)
        self.transform = make_transform(s.codec, backend=s.codec_backend,
                                        device=s.device)
        self.gatherer = Gatherer(s.gather_mode, threshold=s.threshold,
                                 period=s.period)
        self.paths = [p for p, _ in tree.flatten_with_paths(params)]
        self.kinds = {p: ("rows" if p == "embed" and not cfg.tie_embeddings
                          else "dense") for p in self.paths}
        self._path_ids = {p: i for i, p in enumerate(self.paths)}
        self.versions = {p: 0 for p in self.paths}
        self._seq = -1
        self._shadow: dict[str, np.ndarray] = {}
        self._flushes = 0
        self.pushed_bytes = 0
        self.skipped_dense = 0
        self.replicas = [ServeReplica(cfg, params,
                                      codec_backend=s.codec_backend,
                                      device=s.device)
                         for _ in range(s.num_slaves)]
        self.consumers = [Consumer(self.queue, range(s.num_partitions))
                          for _ in self.replicas]

    # -- collect -----------------------------------------------------------
    def collect_step(self, tokens, metrics: Optional[dict] = None) -> None:
        """Record dirty ids after a train step: the unique token rows and a
        version bump for every dense tensor. ``metrics`` (the reference's
        expert counts) has nothing to add for a dense model."""
        if isinstance(tokens, torch.Tensor):
            tokens = tokens.cpu().numpy()
        uniq = np.unique(np.asarray(tokens).reshape(-1)).astype(np.int64)
        self._embed_touched.update(uniq.tolist())
        events = []
        for path, kind in self.kinds.items():
            if kind == "rows":
                events.append((path, uniq, "upsert"))
            else:
                self.versions[path] += 1
                events.append((f"dense::{path}", np.zeros(1, np.int64),
                               "upsert"))
        self.gatherer.offer(events)

    # -- push ---------------------------------------------------------------
    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _changed_enough(self, path: str, value: np.ndarray) -> bool:
        thr = self.sync.delta_threshold
        if thr <= 0:
            return True
        if self.sync.full_refresh_every and \
                self._flushes % self.sync.full_refresh_every == 0:
            return True
        old = self._shadow.get(path)
        if old is None:
            return True
        num = float(np.linalg.norm(value - old))
        den = max(float(np.linalg.norm(old)), 1e-9)
        return (num / den) >= thr

    def _produce(self, part: int, rec: Record) -> None:
        self.queue.produce(part, rec)
        self.pushed_bytes += rec.nbytes()

    def tick(self, params: dict, now: float, *, scatter: bool = True) -> int:
        """Gather-window flush: read the full current values of the dirty
        leaves and rows from the live training params (each dirty leaf to
        host float32), encode, produce; then the replicas consume.
        Returns the number of records produced."""
        n = 0
        if not self.gatherer.ready(now):
            if scatter:
                self.scatter()
            return n
        flat = dict(tree.flatten_with_paths(params))
        gathered = self.gatherer.flush(now)
        self._flushes += 1
        for (group, op), ids in gathered.items():
            path = group[len("dense::"):] if group.startswith("dense::") \
                else group
            leaf = _host_f32(flat[path])
            meta = {"codec": self.transform.name, "kind": self.kinds[path],
                    "path": path, "t": now}
            if self.kinds[path] == "dense":
                if not self._changed_enough(path, leaf):
                    self.skipped_dense += 1
                    continue
                if self.sync.delta_threshold > 0:
                    self._shadow[path] = leaf.copy()
                # a copy: queued payloads must not alias the leaf
                # (identity encode passes arrays through uncopied)
                payload = self.transform.encode(leaf.reshape(1, -1).copy(),
                                                {})
                self._produce(
                    self._path_ids[path] % self.queue.num_partitions,
                    Record(group=group, op=op,
                           ids=np.array([self.versions[path]], np.int64),
                           payload=payload, seq=self._next_seq(),
                           producer=0, meta=meta))
                n += 1
                continue
            if self._embed_mode == "cumulative":
                ids = np.fromiter(self._embed_touched, dtype=np.int64,
                                  count=len(self._embed_touched))
                ids.sort()
            for i in range(0, len(ids), self.sync.embed_row_chunk):
                chunk = ids[i:i + self.sync.embed_row_chunk]
                payload = self.transform.encode(leaf[chunk], {})
                self._produce(
                    int(chunk[0]) % self.queue.num_partitions,
                    Record(group=group, op=op, ids=chunk, payload=payload,
                           seq=self._next_seq(), producer=0,
                           meta=dict(meta)))
                n += 1
        if scatter:
            self.scatter()
        return n

    def scatter(self) -> int:
        n = 0
        for replica, consumer in zip(self.replicas, self.consumers):
            n += replica.apply_batch(list(consumer.poll()))
        return n

    def metrics(self) -> dict:
        return {
            "pushed_bytes": self.pushed_bytes,
            "queue_bytes": self.queue.produced_bytes,
            "dedup_ratio": self.gatherer.stats.dedup_ratio,
            "flushes": self._flushes,
            "skipped_dense": self.skipped_dense,
        }
