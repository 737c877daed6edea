"""Plain PyTorch versions of the serving path's four kernels — the
counterparts the CPU tests hold against the JAX package and that
``chip_smoke.py`` holds each CUDA kernel against on the card.

They run on any device. The kernel wrappers (``kernels/hashmap_probe.py``,
``kernels/embedding_lookup.py``) call them for tensors that lie on the
CPU; for CUDA tensors the wrappers launch the hand-written kernels.

Hash-probe contract (both placements): ``keys`` is an ``IdHashMap`` key
table as int64 (``EMPTY``/``TOMB`` sentinels included), ``ids`` the int64
queries; the result is ``(pos int32, found bool)`` with ``pos`` the
table slot of each found id and unspecified (but in ``[0, cap)``) where
``found`` is False — bit-equal to ``IdHashMap._probe`` where found.
"""

from __future__ import annotations

import torch

EMPTY = -2 ** 63                    # core.hashmap.EMPTY
TOMB = -2 ** 63 + 1                 # core.hashmap.TOMB
_WINDOW = 8                         # core.hashmap._WINDOW
_DMA_WINDOW = 256                   # kernels.hashmap_probe._DMA_WINDOW
# ⌊2^64/φ⌋ as the int64 with the same bits (the constant is above 2^63)
_FIB = 0x9E3779B97F4A7C15 - (1 << 64)


def _check_len(keys: torch.Tensor, want: int, layout: str) -> None:
    if keys.dim() != 1 or keys.shape[0] != want:
        raise ValueError(f"key table must be {layout}: {want} slots, got "
                         f"shape {tuple(keys.shape)}")


def home_slots(ids: torch.Tensor, shift: int) -> torch.Tensor:
    """Fibonacci home slots, bit-equal to ``core.hashmap.home_slots``:
    the top ``64 - shift`` bits of ``id · ⌊2^64/φ⌋ mod 2^64``. The int64
    multiply wraps like the uint64 one; ``>>`` on int64 is arithmetic, so
    the sign-extended bits are masked off after the shift."""
    return ((ids * _FIB) >> shift) & ((1 << (64 - shift)) - 1)


def hashmap_probe(keys: torch.Tensor, ids: torch.Tensor, *,
                  shift: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The windowed walk of ``IdHashMap._probe``: one round at the home
    slot for the whole batch, then 8-slot windows from ``home + 1`` over
    the shrinking unresolved set. In a window, the first hit wins and a
    hit anywhere beats an EMPTY; a window with an EMPTY and no hit ends
    the walk as not-found; TOMB is neither, so the walk goes on. Query
    ids ≤ TOMB are never found. ``keys`` is the exact-capacity table."""
    cap = 1 << (64 - int(shift))
    imask = cap - 1
    _check_len(keys, cap, "exact-capacity")
    bad = ids <= TOMB
    q = torch.where(bad, torch.zeros_like(ids), ids)
    home = home_slots(q, shift)
    k = keys[home]
    found = (k == q) & ~bad
    pos = home.clone()
    idx = torch.nonzero(~found & ~bad & (k != EMPTY)).squeeze(1)
    if idx.numel():
        cur = (home[idx] + 1) & imask
        tgt = q[idx]
        win = torch.arange(_WINDOW, device=ids.device)
        for _ in range(cap // _WINDOW + 2):
            cand = (cur[:, None] + win) & imask                 # (m, W)
            kw = keys[cand]
            hitw = kw == tgt[:, None]
            ha = hitw.any(dim=1)
            first = hitw.to(torch.uint8).argmax(dim=1)          # first hit
            pos[idx[ha]] = cand[ha, first[ha]]
            found[idx[ha]] = True
            cont = ~ha & ~(kw == EMPTY).any(dim=1)
            if not bool(cont.any()):
                break
            idx, tgt = idx[cont], tgt[cont]
            cur = (cur[cont] + _WINDOW) & imask
        else:
            raise RuntimeError("hashmap probe did not terminate")
    return pos.to(torch.int32), found


def wrap_pad(keys: torch.Tensor, *, cap: int,
             window: int = _DMA_WINDOW) -> torch.Tensor:
    """Append the first ``min(window, cap)`` slots to an exact-capacity
    key table, so a window starting anywhere in ``[0, cap)`` reads
    contiguous slots: padded slot ``cap + t`` mirrors slot ``t``."""
    return torch.cat([keys[:cap], keys[:min(window, cap)]])


def hashmap_probe_hbm(keys: torch.Tensor, ids: torch.Tensor, *, shift: int,
                      window: int = _DMA_WINDOW
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The pass structure of the windowed probe over a wrap-padded table
    (the reference's ``_dma_probe_kernel``): every pass reads ``window``
    consecutive slots per unresolved id. The first pass checks the home
    slot (offset 0), then ``(window - 1) // 8`` groups of 8 from offset 1;
    later passes check ``window // 8`` groups from offset 0. The lowest
    group holding a hit or an EMPTY decides, a hit in it beating an
    EMPTY; unresolved ids advance past the groups checked. ``keys`` is
    the table wrap-padded by ``wrap_pad`` with the same ``window``."""
    cap = 1 << (64 - int(shift))
    imask = cap - 1
    w = min(window, cap)
    _check_len(keys, cap + w, "wrap-padded")
    bad = ids <= TOMB
    home = home_slots(torch.where(bad, torch.zeros_like(ids), ids), shift)
    pos = home.clone()
    found = torch.zeros_like(bad)
    idx = torch.nonzero(~bad).squeeze(1)
    cur = home[idx]
    off = torch.arange(w, device=ids.device)
    for r in range(cap // _WINDOW + 2):
        if idx.numel() == 0:
            break
        first = r == 0
        start = 1 if first else 0
        k_groups = (w - 1) // _WINDOW if first else w // _WINDOW
        kw = keys[cur[:, None] + off]                           # (m, w)
        tgt = ids[idx]
        valid = (off >= start) & (off < start + _WINDOW * k_groups)
        grp = torch.div(off - start, _WINDOW, rounding_mode="floor")
        hitw = (kw == tgt[:, None]) & valid
        event = hitw | ((kw == EMPTY) & valid)
        gmin = torch.where(event, grp, w).min(dim=1).values
        resolved = gmin < w
        hit_in = hitw & (grp == gmin[:, None])
        fnd = hit_in.any(dim=1)
        ploc = hit_in.to(torch.uint8).argmax(dim=1)
        if first:
            hit0 = kw[:, 0] == tgt
            empty0 = kw[:, 0] == EMPTY
            resolved = resolved | hit0 | empty0
            fnd = hit0 | (~empty0 & fnd)
            ploc = torch.where(hit0, torch.zeros_like(ploc), ploc)
        newly = resolved & fnd
        pos[idx[newly]] = (cur[newly] + ploc[newly]) & imask
        found[idx[newly]] = True
        alive = ~resolved
        idx = idx[alive]
        cur = (cur[alive] + start + _WINDOW * k_groups) & imask
    return pos.to(torch.int32), found


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row gather: table (V, D); ids (N,) in bounds -> (N, D)."""
    return table[ids.long()]


def embedding_scatter(table: torch.Tensor, ids: torch.Tensor,
                      updates: torch.Tensor) -> torch.Tensor:
    """Row scatter-SET in place: ``table[ids[i]] = updates[i]`` (cast to
    ``table.dtype``); ids UNIQUE. Returns ``table``."""
    table[ids.long()] = updates.to(table.dtype)
    return table
