"""Parameter-server storage of the port: row-addressable sparse tables
(arena-backed) and dense banks, composed into master (training) and
slave (serving) shards.

Master shards hold *training* state: parameter rows plus optimizer slots
(FTRL ``z, n``). Slave shards hold *serving* state only: the inference
weights the sync stream delivers — the paper's heterogeneous-parameter
split (§1.2.1).

The host side is the reference's: an ``IdHashMap`` resolves int64 ids
to arena slots and NumPy arrays stay authoritative. ``backend`` selects
the row engine:

  * ``"numpy"`` — NumPy fancy indexing on the host; the reference path.
  * ``"torch"`` — a lazily-synced device mirror of the key table, the
    slot map and the arenas (``_DeviceMirror``) on ``device``: serve
    lookups run probe → gather on the device (``ops.fused_lookup``) and
    FTRL pushes probe → gather → FTRL → scatter (``ops.fused_ftrl_apply``)
    through the hand-written kernels on CUDA, through their plain
    versions on ``device="cpu"``.

Snapshots (the checkpoint plane's input, ``core/fault_tolerance.py``)
read rows through the same backend-routed gather; the host arrays stay
authoritative, so a snapshot of a ``torch`` table holds the host's bits.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core.hashmap import EMPTY as _NO_ID
from repro_torch.core.hashmap import IdHashMap
from repro_torch.kernels import hashmap_probe as _hm
from repro_torch.kernels import ops
from repro_torch.optim import FTRL, Optimizer

PS_BACKENDS = ("numpy", "torch")


def resolve_device(device) -> torch.device:
    """``torch.device`` for a caller's ``device``; asking for CUDA on a
    host without a usable GPU raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(dev)!r} asked for, but "
                               "torch.cuda.is_available() is False")
    elif dev.type != "cpu":
        raise ValueError(f"device must be cpu or cuda, got {str(dev)!r}")
    return dev


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device COPY of a host array (``.to("cpu")`` of a ``from_numpy``
    view would alias the host array, which the mirror must never do)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


class _DeviceMirror:
    """Lazily-synced device copy of a ``SparseTable``'s probe state (int64
    key table + slot map) and arenas — what lets the ``torch`` backend run
    probe→gather on the device (``ops.fused_lookup``) while the host NumPy
    arrays stay authoritative.

    Staleness is cheap to detect, never scanned for: the hash map's
    structural ``version`` covers the probe state, and the table's
    mutation clock covers the arenas — rows with ``row_version`` past the
    last synced clock are re-uploaded through the ``embedding_scatter``
    kernel (bulk re-upload when more than a quarter of the rows moved or
    the arena changed shape). The keys sync the same way off the map's
    dirty-slot journal (``IdHashMap.track_dirty_slots``).

    Placement: maps up to ``VMEM_SLOT_BOUND`` slots (unless the table
    pins ``device_placement``) keep an exact-capacity key table for the
    in-place walk; larger ones a wrap-padded table for the windowed probe.
    Upload traffic is counted as the reference counts it (a key slot is
    8 bytes, a slot-map entry 4)."""

    def __init__(self, table: "SparseTable"):
        # a weak back-reference: the table owns its mirror, so a table
        # that is replaced (recovery, hot switch) frees the mirror's
        # device tensors by refcount, without waiting for a GC cycle
        self._tref = weakref.ref(table)
        self.device = table.device
        self._map_version = -1
        self._synced_mut = -1
        self.keys: Optional[torch.Tensor] = None
        self.slot_of: Optional[torch.Tensor] = None
        self.arenas: dict[str, torch.Tensor] = {}
        self._placement: Optional[str] = None   # resolved at key sync
        self._cap = 0                           # capacity at last key sync
        self._pad = 0                           # wrap-pad slots (hbm only)
        self.syncs = 0
        self.key_full_uploads = 0
        self.key_incremental_uploads = 0
        self.key_bytes_uploaded = 0
        self.arena_bytes_uploaded = 0
        table._map.track_dirty_slots()

    @property
    def _t(self) -> "SparseTable":
        return self._tref()

    @property
    def shift(self) -> int:
        return int(self._t._map.shift)

    @property
    def placement(self) -> str:
        """Key-table placement at the last sync ("vmem" | "hbm")."""
        if self._placement is None:
            raise RuntimeError("sync() before placement")
        return self._placement

    def _sync_keys(self, m: IdHashMap) -> None:
        cap = m.capacity
        placement = ops.resolve_placement(m.shift, self._t.device_placement)
        slots = None
        if (self.keys is not None and cap == self._cap
                and placement == self._placement):
            slots = m.dirty_slots_since(self._map_version)
        if slots is None:
            # full upload: first sync, realloc/rehash, clear, placement
            # flip, or journal overflow
            keys = _upload(m.key_table, self.device)
            if placement == "hbm":
                keys = _hm.wrap_pad(keys, cap=cap)
            self._pad = keys.shape[0] - cap
            self.keys = keys
            self.slot_of = _upload(m.val_table.astype(np.int32), self.device)
            self.key_full_uploads += 1
            self.key_bytes_uploaded += keys.nbytes + cap * 4
        else:
            if len(slots):
                sl = _upload(slots, self.device)
                self.keys[sl] = _upload(m.key_table[slots], self.device)
                self.slot_of[sl] = _upload(m.val_table[slots].astype(np.int32),
                                           self.device)
                self.key_bytes_uploaded += len(slots) * 12
                if self._pad:
                    # dirty slots inside the wrap-pad mirror region must
                    # land in both places
                    wrap = slots[slots < self._pad]
                    if len(wrap):
                        self.keys[_upload(wrap + cap, self.device)] = \
                            _upload(m.key_table[wrap], self.device)
                        self.key_bytes_uploaded += len(wrap) * 8
            self.key_incremental_uploads += 1
        self._placement = placement
        self._cap = cap
        self._map_version = m.version
        m.trim_dirty_log(m.version)

    def sync(self) -> None:
        t = self._t
        m = t._map
        self.syncs += 1
        if self._map_version != m.version:
            self._sync_keys(m)
        host = t._arenas()
        row_bytes = sum(v.itemsize * v.shape[1] for v in host.values())
        if not self.arenas or tuple(self.arenas["w"].shape) != t._w.shape:
            self.arenas = {k: _upload(v, self.device)
                           for k, v in host.items()}
            self.arena_bytes_uploaded += sum(v.nbytes for v in host.values())
        elif self._synced_mut != t._mut:
            top = t._top
            dirty = np.flatnonzero(t.row_version[:top] > self._synced_mut)
            if len(dirty) * 4 > top:
                self.arenas = {k: _upload(v, self.device)
                               for k, v in host.items()}
                self.arena_bytes_uploaded += sum(v.nbytes
                                                 for v in host.values())
            elif len(dirty):
                sl = _upload(dirty.astype(np.int32), self.device)
                for k, a in self.arenas.items():
                    ops.embedding_scatter(a, sl,
                                          _upload(host[k][dirty], self.device))
                self.arena_bytes_uploaded += len(dirty) * row_bytes
        self._synced_mut = t._mut

    def mark_synced(self) -> None:
        """Record that the device arenas already hold the table's state at
        the current clock (a fused kernel chain just wrote both sides)."""
        self._synced_mut = self._t._mut

    def metrics(self) -> dict:
        return {"syncs": self.syncs,
                "placement": self._placement or "unsynced",
                "key_full_uploads": self.key_full_uploads,
                "key_incremental_uploads": self.key_incremental_uploads,
                "key_bytes_uploaded": self.key_bytes_uploaded,
                "arena_bytes_uploaded": self.arena_bytes_uploaded}


class SparseTable:
    """Row-addressable table over a huge hashed ID space; only touched rows
    exist. Arena storage: a growable (capacity, dim) array + a vectorized
    id→slot hash map, so batched ``ensure``/``lookup``/``evict`` and
    gather/scatter run with no per-row loops. ``device`` is where the
    ``torch`` backend's mirror lives (unused by ``numpy``)."""

    def __init__(self, dim: int, slot_names: tuple[str, ...] = (),
                 init_capacity: int = 1024, dtype=np.float32,
                 backend: str = "torch", device="cuda"):
        if backend not in PS_BACKENDS:
            raise ValueError(f"backend must be one of {PS_BACKENDS}, "
                             f"got {backend!r}")
        self.dim = dim
        self.dtype = dtype
        self.backend = backend
        self.device = resolve_device(device) if backend == "torch" else None
        # key-table placement for the torch backend: "auto" routes by
        # capacity; "vmem"/"hbm" pin it
        self.device_placement = "auto"
        self.slot_names = tuple(slot_names)
        self._map = IdHashMap(init_capacity)
        cap = max(1, init_capacity)
        # reverse map slot→id; _NO_ID marks unused slots
        self._id_of = np.full(cap, _NO_ID, dtype=np.int64)
        self._free = np.empty(0, dtype=np.int64)
        self._top = 0                     # next never-used arena slot
        self._w = np.zeros((cap, dim), dtype=dtype)
        self._slots = {n: np.zeros((cap, dim), dtype=np.float32)
                       for n in self.slot_names}
        self.last_touch = np.zeros((cap,), dtype=np.int64)
        self.touch_count = np.zeros((cap,), dtype=np.int64)
        # mutation clock stamped onto every written row, plus a log of
        # (clock, ids) evictions
        self.row_version = np.zeros((cap,), dtype=np.int64)
        self._mut = 0
        self._evict_log: list[tuple[int, np.ndarray]] = []
        self._dev: Optional[_DeviceMirror] = None   # torch: lazy mirror

    def _mirror(self) -> _DeviceMirror:
        if self._dev is None:
            self._dev = _DeviceMirror(self)
        return self._dev

    def _arenas(self) -> dict[str, np.ndarray]:
        """Host arenas by name: ``"w"`` and every optimizer slot."""
        return {"w": self._w, **self._slots}

    # -- capacity ---------------------------------------------------------
    def __len__(self) -> int:
        return len(self._map)

    def _grow(self, need: int) -> None:
        cap = self._w.shape[0]
        new_cap = max(need, cap * 2)

        def grow(a, fill=0):
            out = np.full((new_cap,) + a.shape[1:], fill, dtype=a.dtype)
            out[:cap] = a
            return out
        self._w = grow(self._w)
        self._slots = {n: grow(a) for n, a in self._slots.items()}
        self._id_of = grow(self._id_of, fill=_NO_ID)
        self.last_touch = grow(self.last_touch)
        self.touch_count = grow(self.touch_count)
        self.row_version = grow(self.row_version)

    def _alloc_slots(self, k: int) -> np.ndarray:
        """Pop ``k`` arena slots: freed slots first (LIFO), then fresh."""
        out = np.empty(k, dtype=np.int64)
        take = min(k, len(self._free))
        if take:
            out[:take] = self._free[len(self._free) - take:][::-1]
            self._free = self._free[:len(self._free) - take]
        fresh = k - take
        if fresh:
            out[take:] = np.arange(self._top, self._top + fresh)
            self._top += fresh
            if self._top > self._w.shape[0]:
                self._grow(self._top)
        return out

    # -- id resolution ----------------------------------------------------
    def ensure(self, ids: np.ndarray) -> np.ndarray:
        """Arena slots for ids, creating zeroed rows as needed."""
        ids = np.asarray(ids, dtype=np.int64)
        sl, found = self._map.lookup_mask(ids)
        if not found.all():
            sl = self._fill_missing(ids, sl, found)
        return sl

    def _fill_missing(self, ids: np.ndarray, sl: np.ndarray,
                      found: np.ndarray) -> np.ndarray:
        miss = ~found
        new_ids = np.unique(ids[miss])            # sorted unique
        new_sl = self._alloc_slots(len(new_ids))
        self._map.insert(new_ids, new_sl)
        self._id_of[new_sl] = new_ids
        self._w[new_sl] = 0.0
        for a in self._slots.values():
            a[new_sl] = 0.0
        self.last_touch[new_sl] = 0
        self.touch_count[new_sl] = 0
        self._mut += 1
        self.row_version[new_sl] = self._mut
        sl[miss] = new_sl[np.searchsorted(new_ids, ids[miss])]
        return sl

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        """Slots for existing ids; -1 where missing."""
        return self._map.lookup(np.asarray(ids, dtype=np.int64))

    def evict(self, ids: np.ndarray) -> int:
        """Batched row removal; freed slots are reused by later ensures."""
        uniq = np.unique(np.asarray(ids, dtype=np.int64))
        sl = self._map.lookup(uniq)
        have = sl >= 0
        if have.any():
            s = sl[have]
            self._map.delete(uniq[have])
            self._id_of[s] = _NO_ID
            self._free = np.concatenate([self._free, s])
            self._mut += 1
            self._evict_log.append((self._mut, uniq[have].copy()))
        return int(have.sum())

    # -- slot-level row access --------------------------------------------
    def _fetch(self, name: str, sl: np.ndarray) -> np.ndarray:
        """Rows ``sl`` of arena ``name``. The torch backend gathers from
        the device mirror's arena (synced first) with the
        ``embedding_lookup`` kernel — where the reference uploaded the
        whole host arena to its gather kernel on every call."""
        if self.backend == "torch" and len(sl):
            mir = self._mirror()
            mir.sync()
            out = ops.embedding_lookup(
                mir.arenas[name], _upload(sl.astype(np.int32), self.device))
            return out.cpu().numpy()
        arena = self._arenas()[name]
        if arena.shape[1] == 1:      # dim-1 rows (LR): element gather beats
            return arena.reshape(-1).take(sl, mode="clip")[:, None]  # rows
        return arena.take(sl, axis=0, mode="clip")

    def read_rows(self, sl: np.ndarray, *, want_w: bool = True,
                  slot_names: Optional[tuple] = None):
        """(w, slots) for resolved arena slots — backend-routed gather.
        Skipped w is a (n, 0) placeholder so row counts stay consistent."""
        names = self.slot_names if slot_names is None else slot_names
        w = self._fetch("w", sl) if want_w else \
            np.empty((len(sl), 0), dtype=self.dtype)
        slots = {n: self._fetch(n, sl) for n in names}
        return w, slots

    def write_rows(self, sl: np.ndarray, w: np.ndarray,
                   slots: Optional[dict] = None, *, step: int = 0) -> None:
        self._w[sl] = w
        if slots:
            for n, v in slots.items():
                self._slots[n][sl] = v
        self.last_touch[sl] = step
        self.touch_count[sl] += 1
        self._mut += 1
        self.row_version[sl] = self._mut

    # -- access -------------------------------------------------------------
    def gather(self, ids: np.ndarray, *, create: bool = False,
               want_w: bool = True, slot_names: Optional[tuple] = None):
        """Returns (w (n,dim), slots dict name->(n,dim)). Missing rows are
        zeros unless ``create``."""
        ids = np.asarray(ids, dtype=np.int64)
        if create:
            sl, found = self._map.lookup_mask(ids)
            if not found.all():
                sl = self._fill_missing(ids, sl, found)
            return self.read_rows(sl, want_w=want_w, slot_names=slot_names)
        if (self.backend == "torch" and want_w and len(ids)
                and not (self.slot_names if slot_names is None
                         else slot_names)):
            # device path: probe + gather against the table mirror — the
            # serve-lookup shape (w only, no slots)
            return self._gather_device(ids), {}
        sl = self.lookup(ids)
        ok = sl >= 0
        if ok.all():
            return self.read_rows(sl, want_w=want_w, slot_names=slot_names)
        names = self.slot_names if slot_names is None else slot_names
        safe = np.where(ok, sl, 0)
        if want_w:
            w = self._fetch("w", safe)
            w = np.where(ok[:, None], w, np.zeros((), dtype=self.dtype))
        else:
            w = np.empty((len(sl), 0), dtype=self.dtype)
        slots = {}
        for n in names:
            v = self._fetch(n, safe)
            slots[n] = np.where(ok[:, None], v, np.float32(0.0))
        return w, slots

    def scatter(self, ids: np.ndarray, w: np.ndarray,
                slots: Optional[dict] = None, *, step: int = 0) -> None:
        self.write_rows(self.ensure(ids), w, slots, step=step)

    def insert_rows(self, ids: np.ndarray, w: np.ndarray,
                    slots: Optional[dict] = None, *, step: int = 0) -> None:
        """Probe-free bulk install of rows whose ids are unique and KNOWN
        absent — the serve cache's fill path."""
        ids = np.asarray(ids, dtype=np.int64)
        if not len(ids):
            return
        fresh = not len(self._free)
        sl = self._alloc_slots(len(ids))
        self._map.insert(ids, sl)
        # with an empty free list the allocated slots are one contiguous
        # run — slice writes are straight memcpys
        dst = slice(int(sl[0]), int(sl[0]) + len(ids)) if fresh else sl
        self._id_of[dst] = ids
        self._w[dst] = w
        if slots:
            for n, v in slots.items():
                self._slots[n][dst] = v
        else:
            for a in self._slots.values():
                a[dst] = 0.0
        self.last_touch[dst] = step
        self.touch_count[dst] = 1
        self._mut += 1
        self.row_version[dst] = self._mut

    def reset(self) -> None:
        """Empty the table but KEEP its allocations (map capacity, arena)."""
        self._map.clear()
        self._id_of[:self._top] = _NO_ID
        self._free = np.empty(0, dtype=np.int64)
        self._top = 0
        self._mut += 1
        self._evict_log.clear()

    def lookup_device(self, ids: np.ndarray):
        """Serve-path rows via the device mirror: probe → gather
        (``ops.fused_lookup``), missing rows zeros.

        Returns ``(rows, found, slot)``: ``rows`` is the DEVICE tensor
        (the predict consumes it there), ``found``/``slot`` small host
        arrays (the serve cache counts misses off ``found`` and stamps
        LRU ticks at ``slot``)."""
        mir = self._mirror()
        mir.sync()
        q = _upload(np.asarray(ids, np.int64), self.device)
        rows, found, slot = ops.fused_lookup(
            mir.keys, mir.slot_of, mir.arenas["w"], q, shift=mir.shift,
            placement=mir.placement)
        return rows, found.cpu().numpy(), slot.cpu().numpy()

    def _gather_device(self, ids: np.ndarray) -> np.ndarray:
        rows, _found, _slot = self.lookup_device(ids)
        return rows.cpu().numpy().astype(self.dtype, copy=False)

    def mirror_metrics(self) -> Optional[dict]:
        """Device-mirror upload counters (None until a torch path has
        touched this table)."""
        return self._dev.metrics() if self._dev is not None else None

    def fused_ftrl_update(self, ids: np.ndarray, sl: np.ndarray,
                          grads: np.ndarray, *, alpha: float, beta: float,
                          l1: float, l2: float, step: int = 0) -> np.ndarray:
        """The fused sparse training hot path (torch backend): probe →
        gather → FTRL → scatter over the device mirror
        (``ops.fused_ftrl_apply``), no host hop between stages. ``ids``
        must be unique and already resolved to arena slots ``sl``
        (``ensure`` ran: row creation stays host-side). The kernel
        chain's row outputs are written back to the host arrays at
        ``sl`` — both sides hold identical bits, so the mirror marks
        itself synced and the next batch uploads nothing but ids and
        grads. Returns the new serve weights ``w'`` for the rows.

        Raises ``RuntimeError`` if an id is absent from the map; the
        chain has then written arena row 0, so the mirror's arenas are
        dropped and the next sync re-uploads them."""
        mir = self._mirror()
        mir.sync()
        z2, n2, w2, found = ops.fused_ftrl_apply(
            mir.keys, mir.slot_of, mir.arenas["z"], mir.arenas["n"],
            mir.arenas["w"], _upload(np.asarray(ids, np.int64), self.device),
            _upload(np.asarray(grads, np.float32), self.device),
            shift=mir.shift, alpha=alpha, beta=beta, l1=l1, l2=l2,
            placement=mir.placement)
        if not bool(found.all()):
            mir.arenas = {}
            raise RuntimeError("fused_ftrl_update on ids absent from the "
                               "map (run ensure first)")
        w_np = w2.cpu().numpy().astype(self.dtype, copy=False)
        self.write_rows(sl, w_np, {"z": z2.cpu().numpy(),
                                   "n": n2.cpu().numpy()}, step=step)
        mir.mark_synced()
        return w_np

    def all_ids(self) -> np.ndarray:
        live = self._id_of[:self._top]
        return live[live != _NO_ID]

    def nbytes(self) -> int:
        live = len(self)
        per_row = self._w.itemsize * self.dim * (1 + len(self._slots))
        return live * per_row

    # -- snapshot (checkpointing) -------------------------------------------
    @property
    def version(self) -> int:
        """Mutation-clock reading; rows with ``row_version > v`` are dirty
        relative to a snapshot taken at clock ``v``."""
        return self._mut

    def snapshot(self) -> dict:
        ids = self.all_ids()
        sl = self.lookup(ids)                     # one probe for everything
        w, slots = self.read_rows(sl)
        return {"ids": ids, "w": w, "slots": slots,
                "last_touch": self.last_touch[sl].copy(),
                "touch_count": self.touch_count[sl].copy(),
                "version": self._mut}

    def delta_snapshot(self, since: int) -> dict:
        """Columnar snapshot of ONLY the rows written after clock ``since``
        plus the ids evicted after it — the payload of an incremental
        checkpoint. One vectorized scan of the reverse map + row_version;
        no hash probes."""
        live = self._id_of[:self._top] != _NO_ID
        sl = np.flatnonzero(live & (self.row_version[:self._top] > since))
        w, slots = self.read_rows(sl)
        dead = [ids for mut, ids in self._evict_log if mut > since]
        deleted = np.unique(np.concatenate(dead)) if dead else \
            np.empty(0, np.int64)
        return {"ids": self._id_of[sl].copy(), "w": w, "slots": slots,
                "last_touch": self.last_touch[sl].copy(),
                "touch_count": self.touch_count[sl].copy(),
                "deleted": deleted, "since": since, "version": self._mut}

    def trim_evict_log(self, before: int) -> None:
        """Drop eviction entries at or below clock ``before`` — safe once
        every future delta is taken against a mark >= ``before``."""
        self._evict_log = [(m, i) for m, i in self._evict_log if m > before]

    def load_rows(self, rows: dict) -> None:
        """Bulk-insert snapshot rows whose ids are unique and NOT yet
        present (the restore path: tables start cleared)."""
        ids = np.asarray(rows["ids"], dtype=np.int64)
        if not len(ids):
            return
        sl = self._alloc_slots(len(ids))
        self._map.insert(ids, sl)
        self._id_of[sl] = ids
        self._w[sl] = rows["w"]
        for n, v in rows["slots"].items():
            self._slots[n][sl] = v
        self.last_touch[sl] = rows["last_touch"]
        self.touch_count[sl] = rows["touch_count"]
        self._mut += 1
        self.row_version[sl] = self._mut

    @classmethod
    def restore(cls, snap: dict, dim: int, slot_names: tuple[str, ...],
                dtype=np.float32, backend: str = "torch",
                device="cuda") -> "SparseTable":
        t = cls(dim, slot_names, init_capacity=max(16, len(snap["ids"])),
                dtype=dtype, backend=backend, device=device)
        t.load_rows(snap)                 # probe-free insert: table is new
        return t


@dataclass
class DenseBank:
    """Named dense tensors (DNN hidden layers etc.) with version counters."""

    tensors: dict[str, np.ndarray] = field(default_factory=dict)
    slots: dict[str, dict[str, np.ndarray]] = field(default_factory=dict)
    versions: dict[str, int] = field(default_factory=dict)

    def put(self, name: str, value: np.ndarray,
            slots: Optional[dict] = None) -> None:
        self.tensors[name] = value
        if slots is not None:
            self.slots[name] = slots
        self.versions[name] = self.versions.get(name, 0) + 1

    def snapshot(self) -> dict:
        return {
            "tensors": {k: v.copy() for k, v in self.tensors.items()},
            "slots": {k: {n: a.copy() for n, a in s.items()}
                      for k, s in self.slots.items()},
            "versions": dict(self.versions),
        }

    def snapshot_delta(self, since: dict[str, int]) -> dict:
        """Same format as ``snapshot`` but holding only tensors whose
        version counter moved past ``since[name]``."""
        names = [k for k, v in self.versions.items()
                 if v > since.get(k, -1)]
        return {
            "tensors": {k: self.tensors[k].copy() for k in names},
            "slots": {k: {n: a.copy() for n, a in self.slots[k].items()}
                      for k in names if k in self.slots},
            "versions": {k: self.versions[k] for k in names},
        }

    @classmethod
    def restore(cls, snap: dict) -> "DenseBank":
        return cls(tensors=dict(snap["tensors"]),
                   slots={k: dict(v) for k, v in snap["slots"].items()},
                   versions=dict(snap["versions"]))


class MasterShard:
    """Training-side PS shard: sparse groups with optimizer slots + a dense
    bank. Gradient pushes update rows through the optimizer and notify the
    collector (dirty ids only — paper §4.1.1). ``backend``/``device`` are
    the tables' row engine; under ``"torch"`` an FTRL store takes the
    fused device route."""

    def __init__(self, shard_id: int, groups: dict[str, int],
                 optimizer: Optimizer, collector=None,
                 backend: str = "torch", device="cuda"):
        """groups: {group_name: row_dim}"""
        self.shard_id = shard_id
        self.optimizer = optimizer
        self.backend = backend
        self.device = device
        self.tables = {g: self._new_table(dim) for g, dim in groups.items()}
        self.dense = DenseBank()
        self.collector = collector
        self.step = 0
        self.fused_batches = 0      # pushes taken by the fused device path
        self.alive = True

    def _new_table(self, dim: int) -> SparseTable:
        slots = tuple(sorted(self.optimizer.init_slots(
            np.zeros((dim,), np.float32)).keys()))
        return SparseTable(dim, slots, backend=self.backend,
                           device=self.device)

    def _check_alive(self) -> None:
        if not self.alive:
            raise RuntimeError(f"master shard {self.shard_id} is down")

    def add_group(self, group: str, dim: int) -> None:
        """Create a new sparse group online (an isolated training
        scenario's namespaced tables). Idempotent for an existing group of
        the same dim."""
        if group in self.tables:
            if self.tables[group].dim != dim:
                raise ValueError(f"group {group!r} exists with dim "
                                 f"{self.tables[group].dim}")
            return
        self.tables[group] = self._new_table(dim)

    def pull(self, group: str, ids: np.ndarray, *, create: bool = True):
        """Trainer pull: current *training* weights for ids. Reads ``w``
        alone: without ``create`` the torch backend answers it with the
        device probe → gather, where the reference also gathers the
        optimizer slots and drops them."""
        self._check_alive()
        w, _ = self.tables[group].gather(ids, create=create, slot_names=())
        return w

    def apply_batch(self, group: str, ids: np.ndarray, grads: np.ndarray,
                    *, step: Optional[int] = None) -> np.ndarray:
        """The fused PS hot path: one batched hash → gather → optimizer
        update → scatter pass for a whole minibatch. Duplicate ids are
        deduplicated with their gradients summed (the sparse-grad
        semantics). Returns the unique ids touched."""
        self._check_alive()
        t = self.tables[group]
        st = self.step if step is None else step
        ids = np.asarray(ids, dtype=np.int64)
        grads = np.asarray(grads, dtype=np.float32)
        uniq, inv, counts = np.unique(ids, return_inverse=True,
                                      return_counts=True)
        if len(uniq) != len(ids):
            # segment-sum duplicate-id grads (sort + reduceat)
            order = np.argsort(inv, kind="stable")
            starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
            grads = np.add.reduceat(
                grads.take(order, axis=0, mode="clip"), starts, axis=0)
        elif len(ids) > 1 and not (ids[1:] >= ids[:-1]).all():
            # unique but unsorted: slots are resolved for sorted ``uniq``,
            # so grad rows must be permuted to match
            grads = grads.take(np.argsort(inv, kind="stable"), axis=0,
                               mode="clip")
        sl = t.ensure(uniq)
        if (self.backend == "torch" and isinstance(self.optimizer, FTRL)
                and t.slot_names == ("n", "z")):
            # fused device route: ensure resolved/created the rows on the
            # host (authoritative side), then probe→gather→FTRL→scatter
            # runs as one kernel chain over the table's device mirror
            o = self.optimizer
            t.fused_ftrl_update(uniq, sl, grads, alpha=o.alpha, beta=o.beta,
                                l1=o.l1, l2=o.l2, step=st)
            self.fused_batches += 1
        else:
            w, slots = t.read_rows(sl)
            new_w, new_slots = self.optimizer.update_rows(
                w, slots, grads, st, backend=self.backend,
                device=self.device)
            t.write_rows(sl, new_w.astype(t.dtype, copy=False), new_slots,
                         step=st)
        self.step = st + 1
        if self.collector is not None:
            self.collector.record(group, uniq, "upsert")
        return uniq

    def push_grad(self, group: str, ids: np.ndarray, grads: np.ndarray,
                  *, step: Optional[int] = None) -> None:
        """Apply gradient rows through the optimizer; record dirty ids."""
        self.apply_batch(group, ids, grads, step=step)

    def push_dense(self, name: str, value: np.ndarray,
                   slots: Optional[dict] = None) -> None:
        self._check_alive()
        self.dense.put(name, value, slots)
        if self.collector is not None:
            self.collector.record_dense(name)

    def delete_rows(self, group: str, ids: np.ndarray) -> None:
        """Feature-filter expiry: remove rows and emit delete records."""
        self.tables[group].evict(ids)
        if self.collector is not None:
            self.collector.record(group, ids, "delete")

    def register_metrics(self, reg, prefix: str = "") -> None:
        """Publish this shard's counters into a
        ``repro_torch.obs.metrics.MetricsRegistry`` (per-table
        ``_DeviceMirror`` counters under ``<prefix>device_mirror``)."""
        from repro_torch.obs.metrics import join
        reg.register(join(prefix, "step"), lambda: self.step)
        reg.register(join(prefix, "fused_batches"),
                     lambda: self.fused_batches)
        reg.register(join(prefix, "rows"),
                     lambda: {g: len(t) for g, t in self.tables.items()})
        reg.register(join(prefix, "device_mirror"),
                     lambda: {g: m for g, t in self.tables.items()
                              if (m := t.mirror_metrics()) is not None})

    # -- fault tolerance ---------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "shard_id": self.shard_id,
            "step": self.step,
            "kind": "full",
            "tables": {g: t.snapshot() for g, t in self.tables.items()},
            "dense": self.dense.snapshot(),
        }

    def delta_snapshot(self, marks: dict[str, int],
                       dense_marks: dict[str, int]) -> dict:
        """Incremental snapshot: per group, only the rows written after
        ``marks[group]`` (the table's mutation clock at the previous
        checkpoint) plus the ids evicted since; dense tensors only where
        the version counter moved."""
        return {
            "shard_id": self.shard_id,
            "step": self.step,
            "kind": "delta",
            "tables": {g: t.delta_snapshot(marks.get(g, 0))
                       for g, t in self.tables.items()},
            "dense": self.dense.snapshot_delta(dense_marks),
        }

    def load_table_rows(self, group: str, rows: dict) -> None:
        """Bulk-load columnar rows (ids/w/slots + touch stats) into one
        group — the unit the recovery router emits. An empty table takes
        the probe-free ``SparseTable.load_rows`` insert; a live table
        (merging load) ensure + write."""
        if not len(rows["ids"]):
            return
        t = self.tables[group]
        if len(t) == 0:
            t.load_rows(rows)
            return
        sl = t.ensure(rows["ids"])
        t.write_rows(sl, rows["w"], rows["slots"])
        t.last_touch[sl] = rows["last_touch"]
        t.touch_count[sl] = rows["touch_count"]

    def load_snapshot(self, snap: dict, *, ids_filter=None) -> None:
        self.step = snap["step"]
        for g, tsnap in snap["tables"].items():
            rows = {k: tsnap[k] for k in
                    ("ids", "w", "slots", "last_touch", "touch_count")}
            if ids_filter is not None:
                keep = ids_filter(rows["ids"])
                rows = {"slots": {k: v[keep]
                                  for k, v in rows["slots"].items()},
                        **{k: rows[k][keep] for k in
                           ("ids", "w", "last_touch", "touch_count")}}
            self.load_table_rows(g, rows)
        # a filtered load is a partial/routed restore — table rows only;
        # dense tensors follow the unfiltered owner-shard load
        if ids_filter is None and snap.get("dense") is not None:
            self.dense = DenseBank.restore(snap["dense"])

    def kill(self) -> None:
        self.alive = False

    def clear(self) -> None:
        """Fresh empty tables on the shard's device (the old tables and
        their device mirrors are released) and an empty dense bank."""
        for g, t in list(self.tables.items()):
            self.tables[g] = SparseTable(t.dim, t.slot_names, dtype=t.dtype,
                                         backend=t.backend,
                                         device=self.device)
        self.dense = DenseBank()


class SlaveShard:
    """Serving-side PS shard: inference weights only, idempotent versioned
    application of stream records (last-writer-wins by ``seq``).
    ``codec_backend`` is the decode engine (``core/transform.py``): the
    ``"torch"`` int8 decode runs the ``dequantize_rows`` kernel on
    ``device``."""

    def __init__(self, shard_id: int, groups: dict[str, int],
                 backend: str = "torch", device="cuda",
                 codec_backend: str = "torch"):
        self.shard_id = shard_id
        self.backend = backend
        self.device = device
        self.codec_backend = codec_backend
        if codec_backend == "torch":
            resolve_device(device)          # raise now, not at first decode
        self.tables = {g: SparseTable(dim, backend=backend, device=device)
                       for g, dim in groups.items()}
        self.dense: dict[str, np.ndarray] = {}
        self.dense_versions: dict[str, int] = {}
        # (group, producer, partition) -> last applied seq, for LWW
        # idempotence. Keyed per partition stream: ids route to
        # partitions deterministically, so partitions are independent
        # ordered streams.
        self._applied_seq: dict[tuple[str, int, int], int] = {}
        # serving-plane invalidation hook, called with (group, ids, op)
        # for every applied sparse batch
        self.on_apply = None
        self.alive = True
        self.applied_records = 0
        self.skipped_records = 0

    @staticmethod
    def _seq_key(record) -> tuple[str, int, int]:
        return (record.group, record.producer,
                record.meta.get("partition", -1))

    def _check_alive(self) -> None:
        if not self.alive:
            raise RuntimeError(f"slave shard {self.shard_id} is down")

    def _decode(self, record) -> np.ndarray:
        from repro_torch.core.transform import decode_record
        return decode_record(record, backend=self.codec_backend,
                             device=self.device)

    def apply(self, record) -> bool:
        """Apply one stream record; returns False if skipped (stale)."""
        self._check_alive()
        key = self._seq_key(record)
        last = self._applied_seq.get(key, -1)
        # strictly-older records are stale (LWW). Equal-seq records are
        # sibling chunks of the SAME flush covering disjoint ids (or exact
        # redeliveries, which are idempotent full-value upserts) — apply.
        if record.seq < last:
            self.skipped_records += 1
            return False
        if record.group.startswith("dense/"):
            name = record.group[len("dense/"):]
            ver = int(record.ids[0])
            if self.dense_versions.get(name, -1) < ver:
                self.dense[name] = self._decode(record)
                self.dense_versions[name] = ver
        elif record.op == "delete":
            self.tables[record.group].evict(record.ids)
            if self.on_apply is not None:
                self.on_apply(record.group, record.ids, "delete")
        else:
            self.tables[record.group].scatter(record.ids,
                                              self._decode(record))
            if self.on_apply is not None:
                self.on_apply(record.group, record.ids, "upsert")
        self._applied_seq[key] = max(last, record.seq)
        self.applied_records += 1
        return True

    def apply_batch(self, records: list) -> list:
        """Batched idempotent application of a poll's worth of records:
        sparse upserts are coalesced per group into ONE decoded value block
        and ONE ``SparseTable.scatter`` (concatenation preserves arrival
        order, so overlapping ids within the batch resolve last-writer-wins
        exactly like sequential ``apply``). Dense records and deletes keep
        the singleton ``apply`` path. Returns the records applied (stale
        ones are skipped and counted)."""
        self._check_alive()
        applied: list = []
        rows: dict[str, tuple[list, list]] = {}

        def flush(group) -> None:
            ids_l, val_l = rows.pop(group)
            ids = ids_l[0] if len(ids_l) == 1 else np.concatenate(ids_l)
            vals = val_l[0] if len(val_l) == 1 else \
                np.concatenate(val_l, axis=0)
            self.tables[group].scatter(ids, vals)
            if self.on_apply is not None:
                self.on_apply(group, ids, "upsert")

        for rec in records:
            if rec.group.startswith("dense/") or rec.op == "delete":
                # a delete must not overtake coalesced-but-unwritten
                # upserts for its group (the deferred scatter would
                # resurrect the evicted rows) — flush those first
                if rec.op == "delete" and rec.group in rows:
                    flush(rec.group)
                if self.apply(rec):
                    applied.append(rec)
                continue
            key = self._seq_key(rec)
            last = self._applied_seq.get(key, -1)
            if rec.seq < last:
                self.skipped_records += 1
                continue
            ids_l, val_l = rows.setdefault(rec.group, ([], []))
            ids_l.append(rec.ids)
            val_l.append(self._decode(rec))
            self._applied_seq[key] = max(last, rec.seq)
            self.applied_records += 1
            applied.append(rec)
        for group in list(rows):
            flush(group)
        return applied

    def add_group(self, group: str, dim: int) -> None:
        """Create a new serve group online. Idempotent for an existing
        group of the same dim."""
        if group in self.tables:
            if self.tables[group].dim != dim:
                raise ValueError(f"group {group!r} exists with dim "
                                 f"{self.tables[group].dim}")
            return
        self.tables[group] = SparseTable(dim, backend=self.backend,
                                         device=self.device)

    def lookup(self, group: str, ids: np.ndarray) -> np.ndarray:
        """Latency-path query: serve weights (missing rows -> zeros).

        A dead replica fails with ``AssertionError`` on purpose:
        ``ReplicaSet.read`` takes exactly that as the signal to fail over.
        Kernel faults raise ``RuntimeError``/``ValueError`` and are not
        mistaken for a dead replica."""
        assert self.alive, f"slave shard {self.shard_id} is down"
        w, _ = self.tables[group].gather(ids, create=False)
        return w

    def register_metrics(self, reg, prefix: str = "") -> None:
        """Publish this shard's apply counters into a
        ``repro_torch.obs.metrics.MetricsRegistry``."""
        from repro_torch.obs.metrics import join
        reg.register(join(prefix, "applied"), lambda: self.applied_records)
        reg.register(join(prefix, "skipped"), lambda: self.skipped_records)
        reg.register(join(prefix, "rows"),
                     lambda: {g: len(t) for g, t in self.tables.items()})

    # -- hot backup ----------------------------------------------------------
    def full_sync_from(self, other: "SlaveShard") -> None:
        """Bootstrap a fresh replica: full copy of a peer's serve state."""
        for g, t in other.tables.items():
            snap = t.snapshot()
            self.tables[g] = SparseTable.restore(
                snap, t.dim, (), dtype=t.dtype, backend=self.backend,
                device=self.device)
        self.dense = {k: v.copy() for k, v in other.dense.items()}
        self.dense_versions = dict(other.dense_versions)
        self._applied_seq = dict(other._applied_seq)

    def kill(self) -> None:
        self.alive = False

    def revive(self) -> None:
        self.alive = True
