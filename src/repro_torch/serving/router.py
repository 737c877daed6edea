"""Shared row-pull routing — the code path the paper's *symmetric fusion*
actually shares between the two planes.

Both the training plane (trainer → master shards) and the serving plane
(predictor → slave replica sets) answer the same question: given a
request's ids, which shard owns each id, and how do we gather every
group's rows in bulk?  ``RowRouter`` answers it once for both: resolve
ownership with ONE argsort segment pass (``core.routing.owner_segments``
— the same primitive the streaming pusher and the recovery router use)
and bulk-fetch each contiguous owner segment, writing results straight
into preallocated output blocks.  The seed looped ``num_groups ×
num_shards`` boolean masks over the whole unique-id set per request.

``WeiPSCluster._pull_rows`` (training) and ``ServingPlane`` (serving)
are both thin adapters over this router — they differ only in the
``fetch`` callback (master ``pull`` with row creation vs. replica-set
read with lag-bounded failover).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.core.routing import RoutingPlan, owner_segments


class RowRouter:
    """Vectorized ownership routing + bulk gather for row requests."""

    def __init__(self, plan: RoutingPlan):
        self.plan = plan

    @staticmethod
    def unique(ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(unique ids, inverse) for a request's flattened id tensor."""
        return np.unique(np.asarray(ids, dtype=np.int64).reshape(-1),
                         return_inverse=True)

    def pull(self, uniq: np.ndarray, groups: dict[str, int],
             owner: np.ndarray,
             fetch: Callable[[int, np.ndarray], dict[str, np.ndarray]],
             ) -> dict[str, np.ndarray]:
        """Gather ``(len(uniq), dim)`` blocks for every group.

        ``owner`` assigns each unique id to a destination shard;
        ``fetch(dst, ids)`` returns ``{group: (m, dim)}`` for one owner
        segment. One argsort pass; segment results are scattered into
        the output blocks by index — no per-destination boolean masks.
        """
        out = {g: np.zeros((len(uniq), dim), np.float32)
               for g, dim in groups.items()}
        for dst, idx in owner_segments(owner):
            vals = fetch(dst, uniq.take(idx, mode="clip"))
            for g, block in vals.items():
                out[g][idx] = block
        return out

    def pull_block(self, uniq: np.ndarray, width: int, owner: np.ndarray,
                   fetch: Callable[[int, np.ndarray], np.ndarray],
                   ) -> np.ndarray:
        """Single-block variant: ``fetch(dst, ids)`` returns one
        ``(m, width)`` block holding every group's columns side by side —
        the layout the serve cache stores, so a whole multi-group request
        fills with one gather per owner segment."""
        # empty, not zeros: owner_segments partitions ALL of uniq, so every
        # row is written exactly once — the memset would be pure overhead
        # on the cold-pull path (this block is multi-MB per request)
        out = np.empty((len(uniq), width), np.float32)
        for dst, idx in owner_segments(owner):
            out[idx] = fetch(dst, uniq.take(idx, mode="clip"))
        return out

    def pull_block_sorted(self, uniq: np.ndarray, width: int,
                          owner: np.ndarray,
                          fetch: Callable[[int, np.ndarray], np.ndarray],
                          ) -> tuple[np.ndarray, np.ndarray]:
        """``pull_block`` that leaves the rows in owner-segment order and
        returns ``(block, order)`` with ``block[i]`` the row for
        ``uniq[order[i]]``. Each segment lands as one contiguous slice
        write instead of a row scatter back into ``uniq`` order — callers
        that re-expand to request order anyway (via an inverse-index
        gather) fold ``order`` into that existing gather, so the scatter
        pass disappears entirely from the cold pull."""
        out = np.empty((len(uniq), width), np.float32)
        parts = []
        off = 0
        for dst, idx in owner_segments(owner):
            out[off:off + len(idx)] = fetch(dst, uniq.take(idx, mode="clip"))
            parts.append(idx)
            off += len(idx)
        order = (np.concatenate(parts) if parts
                 else np.empty(0, dtype=np.int64))
        return out, order

    @staticmethod
    def expand(vals: dict[str, np.ndarray], inverse: np.ndarray,
               shape: tuple[int, int]) -> dict[str, np.ndarray]:
        """Unique-space blocks → per-example ``(B, F, dim)`` tensors."""
        b, f = shape
        return {g: v.take(inverse, axis=0, mode="clip").reshape(b, f, -1)
                for g, v in vals.items()}
