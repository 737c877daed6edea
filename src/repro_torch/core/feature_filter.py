"""Feature admission and expiry (paper §4.1c: "feature filter") — a copy
of the reference's ``core/feature_filter.py`` over the port's
``IdHashMap``.

Admission: count-threshold entry so one-off junk features never allocate
PS rows. Expiry: rows untouched for ``ttl_steps`` are deleted — and the
deletion is *streamed* to slaves (the sync mechanism must support
parameter deletion, §4.1c).

Both paths are batched: admission counts live in a vectorized
``IdHashMap`` (id → running count) and expiry is one masked scan over the
table's ``last_touch`` column. The admission map is bounded: past
``max_tracked`` ids a decay-and-trim pass halves every count, drops ids
that reach zero, and (if still over half the bound) evicts the
lowest-count survivors down to ``max_tracked // 2``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.hashmap import IdHashMap


@dataclass
class FeatureFilter:
    min_count: int = 1            # admissions below this never create rows
    ttl_steps: int = 10_000       # expiry horizon (in master steps)
    max_tracked: int = 1 << 20    # admission-map bound (ids); decay past it
    counts: IdHashMap = field(default_factory=IdHashMap)
    trims: int = 0

    def admit(self, ids: np.ndarray) -> np.ndarray:
        """Returns the unique ids admitted for row creation: those whose
        cumulative observation count has reached ``min_count``."""
        ids = np.asarray(ids, dtype=np.int64)
        if self.min_count <= 1:
            return ids
        uniq, batch_counts = np.unique(ids, return_counts=True)
        total = self.counts.lookup(uniq, default=0) + batch_counts
        self.counts.put(uniq, total)
        if len(self.counts) > self.max_tracked:
            self._trim()
        return uniq[total >= self.min_count]

    def _trim(self) -> None:
        """Decay-and-trim: halve every admission count, drop ids that hit
        zero, then (if still over half the bound) evict the lowest-count
        survivors down to ``max_tracked // 2``. Admission state only gates
        row *creation*, so decaying an admitted id never touches its PS
        row."""
        ids, counts = self.counts.items()
        counts = counts // 2
        keep = counts > 0
        ids, counts = ids[keep], counts[keep]
        target = max(1, self.max_tracked // 2)
        if len(ids) > target:
            top = np.argpartition(counts, len(counts) - target)[-target:]
            ids, counts = ids[top], counts[top]
        fresh = IdHashMap(max(16, len(ids) * 4))
        if len(ids):
            fresh.put(ids, counts)
        self.counts = fresh
        self.trims += 1

    def expired(self, table, step: int) -> np.ndarray:
        """IDs whose last touch is older than ttl_steps."""
        ids = table.all_ids()
        if len(ids) == 0:
            return ids
        sl = table.lookup(ids)
        stale = table.last_touch[sl] < (step - self.ttl_steps)
        return ids[stale]
