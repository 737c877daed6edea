"""Vectorized open-addressing id→value hash map (the PS addressing core).

The parameter-server hot path resolves *minibatches* of int64 feature IDs
to arena slots. A Python ``dict`` forces a per-row interpreter loop —
hundreds of ns per ID, worse once the table outgrows cache — which caps
the whole PS at toy throughput (Monolith/PERSIA both make collisionless /
open-addressed embedding addressing the first-order fix). ``IdHashMap``
keeps the table as two flat NumPy arrays (keys, values) with linear
probing, so ``lookup`` / ``put`` / ``delete`` over a batch of N ids run a
handful of vectorized passes.

Probe structure (tuned for batch cost, not per-id cost):
  1. one single-slot round over the whole batch — at ≤50 % load this
     resolves the large majority of ids with two array gathers;
  2. windowed rounds over the shrinking remainder: each round fetches
     ``_WINDOW`` consecutive slots per unresolved id, so an id whose
     remaining cluster run is shorter than the window resolves in one
     round instead of run-length rounds.

Slot occupancy is encoded in the key array itself with two reserved
sentinels (the two most-negative int64 values — see ``EMPTY``/``TOMB``),
halving hot-path gather traffic versus a separate state array. Any other
int64 is a valid id. Deletion tombstones; the map rehashes (reclaiming
tombstones) when live + tombstone load crosses 25 %, which also keeps
cluster runs short for the windowed probe.
"""

from __future__ import annotations

import numpy as np

EMPTY = np.int64(-2 ** 63)          # reserved: empty slot
TOMB = np.int64(-2 ** 63 + 1)       # reserved: tombstone (deleted slot)

_WINDOW = 8           # slots fetched per vectorized tail round

_FIB = np.uint64(0x9E3779B97F4A7C15)      # ⌊2^64/φ⌋, odd


def home_slots(ids: np.ndarray, shift: np.uint64) -> np.ndarray:
    """Fibonacci hashing: the top ``64-shift`` bits of ``id·⌊2^64/φ⌋``.
    Two vector ops (multiply wraps mod 2^64, then shift) versus ~9 for a
    full SplitMix64 finalizer — at ≤25 % load with windowed tail probing
    the weaker low-bit avalanche costs nothing, and golden-ratio steps
    spread sequential ids perfectly. ``ids`` must be a contiguous int64
    array (the uint64 view is a free reinterpret, as is the int64 view of
    the result — slot indices are far below 2^63)."""
    return ((ids.view(np.uint64) * _FIB) >> shift).view(np.int64)


class IdHashMap:
    """Open-addressed int64→int64 map with batched, loop-free operations.

    Ids may be any int64 except the two reserved sentinel values
    (``EMPTY``, ``TOMB`` — the two most-negative int64s)."""

    def __init__(self, capacity: int = 1024):
        # structural version: bumped whenever the key table's CONTENTS or
        # layout change (alloc/rehash, insert, delete). Device mirrors of
        # the probe state (kernels/hashmap_probe.py) key their staleness
        # off this counter.
        self.version = 0
        # dirty-slot journal (off by default — zero overhead for maps with
        # no device mirror): once ``track_dirty_slots`` arms it, every
        # mutation records WHICH table slots it wrote, so a mirror can
        # re-upload just those slots instead of the whole key table on
        # every version bump. ``_journal_floor`` is the version before
        # which per-slot knowledge is lost (journal armed later, realloc,
        # clear, or overflow) — ``dirty_slots_since`` answers None there
        # and the mirror falls back to a full upload.
        self._journal: list[tuple[int, np.ndarray]] | None = None
        self._journal_floor = 0
        self._journal_slots = 0
        self._alloc(1 << max(4, int(capacity - 1).bit_length()))

    def _alloc(self, cap: int) -> None:
        self._cap = cap
        self._shift = np.uint64(64 - (cap.bit_length() - 1))
        self._imask = cap - 1
        self._keys = np.full(cap, EMPTY, dtype=np.int64)
        self._vals = np.zeros(cap, dtype=np.int64)
        self._size = 0
        self._tombs = 0
        self.version += 1
        self._journal_reset()           # layout changed: every slot moved

    # -- dirty-slot journal (device-mirror incremental sync) ----------------
    def track_dirty_slots(self) -> None:
        """Arm the journal (idempotent). Mutations before this call are
        not covered — ``dirty_slots_since`` of an older version answers
        None (full upload)."""
        if self._journal is None:
            self._journal = []
            self._journal_floor = self.version
            self._journal_slots = 0

    def _journal_reset(self) -> None:
        if self._journal is not None:
            self._journal = []
        self._journal_floor = self.version
        self._journal_slots = 0

    def _note_dirty(self, slots: np.ndarray) -> None:
        if self._journal is None or not len(slots):
            return
        # bound journal memory: past a quarter of the capacity a full
        # upload is cheaper than replaying the log anyway
        self._journal_slots += len(slots)
        if self._journal_slots * 4 > self._cap:
            self._journal_reset()
            return
        self._journal.append((self.version, np.asarray(slots, np.int64)))

    def dirty_slots_since(self, version: int) -> np.ndarray | None:
        """Unique table slots written after ``version``, or None when the
        journal cannot answer (unarmed, armed later than ``version``,
        realloc/clear/overflow since) — None means re-upload everything."""
        if self._journal is None or version < self._journal_floor:
            return None
        parts = [s for v, s in self._journal if v > version]
        if not parts:
            return np.empty(0, np.int64)
        return np.unique(np.concatenate(parts))

    def trim_dirty_log(self, version: int) -> None:
        """Drop journal entries at or below ``version`` — safe once every
        mirror has synced past it."""
        if self._journal is None:
            return
        self._journal = [(v, s) for v, s in self._journal if v > version]
        self._journal_slots = int(sum(len(s) for _, s in self._journal))

    # -- introspection ------------------------------------------------------
    def __len__(self) -> int:
        return self._size

    def __contains__(self, rid: int) -> bool:
        return bool(self.lookup(np.array([rid], np.int64))[0] >= 0)

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def load_factor(self) -> float:
        return (self._size + self._tombs) / self._cap

    @property
    def shift(self) -> np.uint64:
        """The Fibonacci-hash shift for the current capacity — with
        ``key_table`` this is the whole probe state a device-resident
        mirror needs (see ``kernels/hashmap_probe.py``)."""
        return self._shift

    @property
    def key_table(self) -> np.ndarray:
        """The raw slot-id array (``EMPTY``/``TOMB`` sentinels included),
        NOT a copy: read-only input for device probe mirrors. Stale after
        any mutation — check ``version``."""
        return self._keys

    @property
    def val_table(self) -> np.ndarray:
        """The raw value array, positionally aligned with ``key_table``
        (garbage at non-live slots). Same staleness contract."""
        return self._vals

    def clear(self) -> None:
        """Empty the map WITHOUT shrinking — one memset versus a realloc.
        Reset-and-refill consumers (the serve cache's cold flush) keep
        their grown capacity, so the refill pays no growth rehashes and
        the next probe hits the presized EMPTY-home fast path."""
        self._keys.fill(EMPTY)
        self._size = 0
        self._tombs = 0
        self.version += 1
        self._journal_reset()           # every slot changed: full upload

    def keys(self) -> np.ndarray:
        return self._keys[self._keys > TOMB].copy()    # sentinels are the
                                                       # two smallest int64s

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        live = self._keys > TOMB
        return self._keys[live].copy(), self._vals[live].copy()

    # -- probing ------------------------------------------------------------
    def _probe(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Table positions for ``ids``: (pos, found). Where ``found`` is
        False the chain reached an EMPTY slot and ``pos`` is meaningless.

        In-window resolution is order-safe: inserts claim the first
        non-FULL slot from an id's home, so a live key never sits after an
        EMPTY slot on its own chain."""
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        if ids.size == 0:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool)
        bad = None
        if int(ids.min()) <= int(TOMB):      # sentinel-valued queries can
            bad = ids <= TOMB                # never be stored: mask them
            ids = np.where(bad, np.int64(0), ids)
        # round 1: single slot, whole batch. ``mode="clip"`` everywhere:
        # indices are in-bounds by construction, and clip skips NumPy's
        # per-element bounds-check slow path (~5× faster gathers).
        cur = home_slots(ids, self._shift)
        k = self._keys.take(cur, mode="clip")
        hit = k == ids
        pos = cur                    # unresolved entries are overwritten in
        found = hit                  # the tail; garbage where found=False
        # ids missing at an EMPTY home slot are definitive misses (inserts
        # claim the first non-FULL slot from home, so a live key never sits
        # past an EMPTY slot on its own chain): resolve them here instead
        # of paying a windowed tail round. The test runs over the round-1
        # miss subset only, so all-hit hot batches skip it entirely —
        # while miss-heavy batches (cold serve pulls probing a near-empty
        # cache) drop from one (m, W) window gather to an (m,) compare.
        idx = np.flatnonzero(~hit)
        if idx.size:
            idx = idx[k.take(idx, mode="clip") != EMPTY]
        if idx.size:
            # tail rounds: window per unresolved id
            cur = (cur[idx] + 1) & self._imask
            tgt = ids[idx]
            win = np.arange(_WINDOW)
            for _ in range(self._cap // _WINDOW + 2):
                cand = (cur[:, None] + win) & self._imask      # (m, W)
                kw = self._keys.take(cand, mode="clip")
                hitw = kw == tgt[:, None]
                ha = hitw.any(axis=1)
                if ha.any():
                    rows = np.nonzero(ha)[0]
                    pos[idx[rows]] = cand[rows, hitw.argmax(axis=1)[rows]]
                    found[idx[rows]] = True
                cont = ~ha & ~(kw == EMPTY).any(axis=1)
                sel = np.nonzero(cont)[0]
                if sel.size == 0:
                    break
                idx = idx[sel]
                tgt = tgt[sel]
                cur = (cur[sel] + _WINDOW) & self._imask
            else:
                raise RuntimeError("IdHashMap probe did not terminate")
        if bad is not None:
            found[bad] = False
        return pos, found

    def lookup_mask(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Batched get: (values, found). Values are garbage where ``found``
        is False — the zero-branch primitive the PS ensure path builds on."""
        pos, found = self._probe(ids)
        return self._vals.take(pos, mode="clip"), found

    def lookup(self, ids: np.ndarray, default: int = -1) -> np.ndarray:
        """Batched get: values for ids, ``default`` where missing."""
        v, found = self.lookup_mask(ids)
        if found.all():                       # hot path: every id present
            return v
        return np.where(found, v, np.int64(default))

    # -- mutation -----------------------------------------------------------
    def put(self, ids: np.ndarray, vals: np.ndarray) -> None:
        """Batched upsert. ``ids`` must be unique within the call (batch
        callers dedupe with np.unique; duplicate ids in one put would race
        for the same chain)."""
        ids = np.asarray(ids, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.int64)
        pos, found = self._probe(ids)
        if found.any():
            self._vals[pos[found]] = vals[found]
            # value-only rewrites move no keys but DO change the slot→val
            # mapping a device mirror holds: version them like any other
            # table mutation so mirrors refresh those slots
            self.version += 1
            self._note_dirty(pos[found])
        miss = ~found
        if miss.any():
            self._insert_new(ids[miss], vals[miss])

    def insert(self, ids: np.ndarray, vals: np.ndarray) -> None:
        """Batched insert of ids the caller KNOWS are unique and absent
        (e.g. just confirmed by ``lookup``) — skips the existence probe."""
        self._insert_new(np.asarray(ids, dtype=np.int64),
                         np.asarray(vals, dtype=np.int64))

    def _maybe_grow(self, extra: int) -> None:
        # grow at 25 % load (live + tombstones): short cluster runs keep
        # the probe at ~one vectorized round per batch (space/time trade in
        # the Monolith collisionless-table spirit: 16 B/id of map overhead
        # is noise next to the parameter rows it addresses).
        if (self._size + self._tombs + extra) * 4 < self._cap:
            return
        cap = self._cap
        need = self._size + extra                 # rehash clears tombstones
        while need * 4 >= cap:
            cap *= 2
        live = self._keys > TOMB
        keys, vals = self._keys[live].copy(), self._vals[live].copy()
        self._alloc(cap)
        if len(keys):
            self._insert_new(keys, vals)

    def _insert_new(self, ids: np.ndarray, vals: np.ndarray) -> None:
        """Insert ids known to be unique AND absent. Round-based
        write-and-verify claiming: every pending id blindly writes its
        (id, val) pair to its current probe slot — candidates racing for
        one slot overwrite each other, but the LAST writer lands both
        arrays consistently — then one re-gather of the key column
        identifies the winners. Losers (and ids whose slot was already
        occupied) advance one step and retry — all vectorized. Versus a
        scatter-claim election into a side array this halves the scatter
        traffic of the dominant round (the whole batch, on a bulk fill)
        and needs no per-capacity scratch; versus the sort a
        ``np.unique(return_index)`` election costs it is O(m) per round.
        Blind writes are safe because candidate slots are free by the
        occupancy test taken in the same round, and ids are unique."""
        if len(ids) and (ids <= TOMB).any():
            raise ValueError("ids -2**63 and -2**63+1 are reserved")
        self._maybe_grow(len(ids))
        self.version += 1
        n = len(ids)
        if n == 0:
            return
        claimed: list[np.ndarray] = []      # journal: slots won per round
        vals = np.asarray(vals, dtype=np.int64)
        pos = home_slots(np.ascontiguousarray(ids), self._shift)
        # int32 pending indices (row counts are far below 2^31): half the
        # bookkeeping bytes of int64 on compress/advance passes
        pending = np.arange(n, dtype=np.int32)
        # bulk-fill shortcut (cleared/presized map, the serve-cache cold
        # install): with no occupants, round-1 contention is batch-internal
        # only — skip the occupancy gather and the tombstone accounting
        pristine = self._size == 0 and self._tombs == 0
        for _ in range(2 * self._cap + 2):
            p = pos.take(pending, mode="clip")
            if pristine:
                kf = None                                # everything free
                whole, cand, cp = True, pending, p
            else:
                k = self._keys.take(p, mode="clip")
                free = k <= TOMB                         # EMPTY or TOMB
                whole = free.all()
                if whole:
                    cand, cp, kf = pending, p, k
                elif free.any():
                    cand, cp, kf = pending[free], p[free], k[free]
                else:
                    cand = None
            if cand is not None:
                idc = ids.take(cand, mode="clip")
                self._keys[cp] = idc
                self._vals[cp] = vals.take(cand, mode="clip")
                winmask = self._keys.take(cp, mode="clip") == idc
                nwin = int(winmask.sum())
                if kf is not None:
                    # pre-write occupancy at the won slots: reclaimed
                    # tombstones come off the tombstone count
                    self._tombs -= int((kf[winmask] == TOMB).sum())
                self._size += nwin
                if self._journal is not None and nwin:
                    claimed.append(cp[winmask])
                if nwin == len(pending):
                    if claimed:
                        self._note_dirty(np.concatenate(claimed))
                    return
                if whole:
                    # cand IS pending: losers drop out by mask, no O(n)
                    # won-table bookkeeping (this is the dominant round of
                    # a bulk fill — the whole batch is here)
                    pending = pending[~winmask]
                else:
                    won = np.zeros(n, dtype=bool)
                    won[cand[winmask]] = True
                    pending = pending[~won.take(pending, mode="clip")]
            # every survivor now sits on a FULL slot (pre-occupied or just
            # claimed by a race winner): advance the whole front. A
            # pristine table's survivors lost to a batch sibling, so the
            # table is no longer conflict-free past round 1.
            pristine = False
            pos[pending] = (pos.take(pending, mode="clip") + 1) & self._imask
        raise RuntimeError("IdHashMap insert did not terminate (table full?)")

    def delete(self, ids: np.ndarray) -> int:
        """Batched delete (tombstoning); returns #ids actually removed."""
        ids = np.unique(np.asarray(ids, dtype=np.int64))
        pos, found = self._probe(ids)
        p = pos[found]
        if len(p):
            self._keys[p] = TOMB
            k = len(p)
            self._size -= k
            self._tombs += k
            self.version += 1
            self._note_dirty(p)
        return int(len(p))
