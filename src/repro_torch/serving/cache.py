"""Version-aware serve caches (predictor side).

``ServeCache`` short-circuits the shard pull for hot ids: one
``IdHashMap``-backed arena (a ``SparseTable`` — the same probe/gather
engine the shards run) stores, per row id, the columns of EVERY group the
scenario reads side by side, so a cached request costs ONE probe + ONE
gather regardless of group count. Entries are invalidated by the stream's
applied-id batches (``SlaveShard.on_apply``), which keeps cached reads
bit-equal to direct replica reads.

``DenseCache`` memoizes dense tensors by their sync version counter.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.core.ps import SparseTable
from repro_torch.obs import trace as obs_trace


class ServeCache:
    """Combined-group row cache keyed by id, invalidated by the stream.
    Under the ``torch`` backend its arena is mirrored on ``device``."""

    def __init__(self, groups: dict[str, int], max_rows: int = 1 << 20,
                 backend: str = "torch", device="cuda"):
        self.groups = dict(groups)
        self.offsets: dict[str, tuple[int, int]] = {}
        lo = 0
        for g, dim in self.groups.items():
            self.offsets[g] = (lo, lo + dim)
            lo += dim
        self.width = lo
        self.max_rows = max_rows
        self.table = SparseTable(self.width, backend=backend, device=device,
                                 init_capacity=1024)
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.invalidated = 0
        self.trims = 0
        # counter snapshot at the last window_stats() read
        self._window_mark = {"hits": 0, "misses": 0, "invalidated": 0,
                             "trims": 0}

    def __len__(self) -> int:
        return len(self.table)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def lookup(self, ids: np.ndarray) -> tuple[Optional[np.ndarray],
                                               np.ndarray]:
        """Host path: (block (n, width), hit mask). Rows where the mask is
        False are zeros — the caller pulls them from the shards and
        ``fill``s. ``block`` is None when NOTHING hit."""
        self._tick += 1
        if not len(self.table):
            # cold cache: every id misses; skip the probe of an empty map
            self.misses += len(ids)
            return None, np.zeros(len(ids), dtype=bool)
        sl = self.table.lookup(ids)
        hit = sl >= 0
        n_hit = int(hit.sum())
        self.hits += n_hit
        self.misses += len(ids) - n_hit
        if n_hit == len(ids):
            w, _ = self.table.read_rows(sl)
            self.table.last_touch[sl] = self._tick      # LRU signal
            return w, hit
        if n_hit == 0:
            return None, hit
        block = np.zeros((len(ids), self.width), np.float32)
        s = sl[hit]
        w, _ = self.table.read_rows(s)
        block[hit] = w
        self.table.last_touch[s] = self._tick
        return block, hit

    def lookup_device(self, ids: np.ndarray):
        """Device twin of ``lookup`` (torch backend): ONE probe→gather
        against the cache table's device mirror returns the combined-group
        block as a DEVICE tensor plus the probe's found mask — misses are
        counted off that mask instead of re-probing on host. Rows where
        the mask is False are zeros. Returns ``(block | None, hit)`` with
        the same cold-path contract as ``lookup``."""
        self._tick += 1
        if not len(self.table):
            self.misses += len(ids)
            return None, np.zeros(len(ids), dtype=bool)
        rows, hit, slot = self.table.lookup_device(ids)
        n_hit = int(hit.sum())
        self.hits += n_hit
        self.misses += len(ids) - n_hit
        if n_hit == 0:
            return None, hit
        self.table.last_touch[slot[hit]] = self._tick       # LRU signal
        return rows, hit

    def fill(self, ids: np.ndarray, block: np.ndarray) -> None:
        """Install pulled rows — the UNIQUE MISS SET of the preceding
        lookup, so the install is a probe-free ``insert_rows``. Trims
        least-recently-touched rows once the arena outgrows ``max_rows``."""
        if not len(ids):
            return
        self.table.insert_rows(ids, block, step=self._tick)
        if len(self.table) > self.max_rows:
            self._trim()

    def _trim(self) -> None:
        ids = self.table.all_ids()
        drop = len(ids) - self.max_rows // 2
        if drop <= 0:
            return
        sl = self.table.lookup(ids)
        oldest = np.argpartition(self.table.last_touch[sl], drop)[:drop]
        self.table.evict(ids[oldest])
        self.table.trim_evict_log(self.table.version)
        self.trims += 1

    def invalidate(self, ids: np.ndarray) -> int:
        """Drop rows the stream just rewrote or deleted."""
        if not len(self.table):
            return 0
        tr = obs_trace.get_tracer()
        if tr.enabled:
            with tr.span("cache.invalidate", ids=len(ids)):
                return self._invalidate(ids)
        return self._invalidate(ids)

    def _invalidate(self, ids: np.ndarray) -> int:
        n = self.table.evict(ids)
        if n:
            # a cache is never checkpointed: keep its eviction log empty
            self.table.trim_evict_log(self.table.version)
        self.invalidated += n
        return n

    def clear(self) -> None:
        """Full flush, keeping the grown arena and map capacity."""
        self.table.reset()

    def split(self, block: np.ndarray) -> dict[str, np.ndarray]:
        """Carve a combined block back into per-group column views."""
        return {g: block[:, lo:hi] for g, (lo, hi) in self.offsets.items()}

    def stats(self) -> dict:
        return {"rows": len(self), "hits": self.hits, "misses": self.misses,
                "hit_rate": self.hit_rate, "invalidated": self.invalidated,
                "trims": self.trims}

    def register_metrics(self, reg, prefix: str = "cache") -> None:
        """Publish the lifetime counters under ``prefix``."""
        reg.register(prefix, self.stats)

    def window_stats(self) -> dict:
        """Counter deltas since the previous ``window_stats`` call, then
        start a new window (lifetime counters untouched)."""
        cur = {"hits": self.hits, "misses": self.misses,
               "invalidated": self.invalidated, "trims": self.trims}
        out = {k: cur[k] - self._window_mark[k] for k in cur}
        n = out["hits"] + out["misses"]
        out["hit_rate"] = out["hits"] / n if n else 0.0
        out["rows"] = len(self)
        self._window_mark = cur
        return out


class DenseCache:
    """Dense tensors memoized by sync version — one reshape per version,
    not one pull per predict."""

    def __init__(self):
        self._cached: dict[str, tuple[int, np.ndarray]] = {}
        self.hits = 0
        self.refreshes = 0
        self.invalidated = 0
        self._window_mark = {"hits": 0, "refreshes": 0, "invalidated": 0}

    def get(self, name: str, shape: tuple[int, ...], version: int,
            fetch: Callable[[], Optional[np.ndarray]]) -> np.ndarray:
        cur = self._cached.get(name)
        # >= : a lagging replica may report an OLDER version than what is
        # cached — serving the cached newer tensor is fresher and stable
        if cur is not None and cur[0] >= version:
            self.hits += 1
            return cur[1]
        v = fetch()
        arr = (np.asarray(v, np.float32).reshape(shape) if v is not None
               else np.zeros(shape, np.float32))
        self._cached[name] = (version, arr)
        self.refreshes += 1
        return arr

    def clear(self) -> None:
        self._cached = {}
        self.invalidated += 1

    def stats(self) -> dict:
        n = self.hits + self.refreshes
        return {"rows": len(self._cached), "hits": self.hits,
                "misses": self.refreshes,
                "hit_rate": self.hits / n if n else 0.0,
                "invalidated": self.invalidated}

    def window_stats(self) -> dict:
        cur = {"hits": self.hits, "refreshes": self.refreshes,
               "invalidated": self.invalidated}
        out = {"hits": cur["hits"] - self._window_mark["hits"],
               "misses": cur["refreshes"] - self._window_mark["refreshes"],
               "invalidated": (cur["invalidated"]
                               - self._window_mark["invalidated"]),
               "rows": len(self._cached)}
        n = out["hits"] + out["misses"]
        out["hit_rate"] = out["hits"] / n if n else 0.0
        self._window_mark = cur
        return out
