"""Plain PyTorch versions of the port's kernels — the counterparts the
CPU tests hold against the JAX package and that ``chip_smoke.py`` holds
each CUDA kernel against on the card.

They run on any device. The kernel wrappers (``kernels/hashmap_probe.py``,
``kernels/embedding_lookup.py``, ``kernels/ftrl_row_update.py``,
``kernels/delta_codec.py``, ``kernels/flash_attention.py``,
``kernels/decode_attention.py``) call them for tensors that lie on the
CPU; for CUDA tensors the wrappers launch the hand-written kernels.

The attention versions compute what the TPU kernels compute (fp32 scores
of a query scaled on fp32 values, a -1e30 mask, fp32 softmax, the
denominator clamped at 1e-30) as whole-row softmaxes; the kernels' online
softmax sums in another order, so the two agree within a tolerance, not
bit for bit.

The row scatter-add adds each id's duplicates in input order, rounding
to the table's dtype after every add, bit-equal to the Pallas kernel in
interpret mode and to the CUDA kernel.

The FTRL and int8 codec versions repeat their kernel's arithmetic op for
op in float32, bit-equal to the NumPy routes (``FTRL.update_rows``,
``Int8Transform._quantize_np``): every scalar is a 0-dim float32 tensor
on the data's device, rounded from the Python float once, so no op takes
a CPU-scalar shortcut (PyTorch's CUDA true divide by a CPU scalar
multiplies by its reciprocal instead).

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


def embedding_scatter_add(table: torch.Tensor, ids: torch.Tensor,
                          updates: torch.Tensor) -> torch.Tensor:
    """Row scatter-ADD in place: ``table[ids[i]] += updates[i]`` (cast to
    ``table.dtype`` first), duplicates accumulating IN INPUT ORDER, each
    add rounded to ``table.dtype`` — the Pallas kernel's sequential
    ``+=`` over stably sorted ids. The ids of one duplicate rank ``r``
    (the r-th occurrence of each id) are unique, so rank by rank,
    ``table[ids_r] += upd_r`` adds each row's r-th update after its
    (r-1)-th. ``index_add_`` is not used: its order of accumulation is
    unspecified. Returns ``table``."""
    n = ids.shape[0]
    if n == 0:
        return table
    sid, order = torch.sort(ids.long(), stable=True)
    upd = updates.to(table.dtype)[order]
    idx = torch.arange(n, device=sid.device)
    first = torch.ones(n, dtype=torch.bool, device=sid.device)
    first[1:] = sid[1:] != sid[:-1]
    rank = idx - torch.cummax(torch.where(first, idx, 0), 0).values
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        rows = sid[sel]
        table[rows] = table[rows] + upd[sel]
    return table


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to float32 once, as a 0-dim tensor beside ``like``:
    filled on that device (``torch.tensor`` would copy it from the host,
    a blocking copy on a CUDA device)."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded to nearest, as IEEE (NumPy, the
    card's ``__fsqrt_rn``) rounds it. PyTorch's CPU ``sqrt`` is a
    vectorised approximation that misses by an ulp on some inputs, so
    the root comes from float64 and is then corrected: ``r`` is right
    exactly when ``x`` lies between the squares of the midpoints to its
    float32 neighbours, and those squares are exact in float64 (a
    25-bit midpoint squares to 50 bits)."""
    x64 = x.double()
    r = torch.sqrt(x64).float()             # within one float32 ulp
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    hi = (r.double() + up.double()) * 0.5
    r = torch.where(x64 > hi * hi, up, r)
    down = torch.nextafter(r, torch.zeros_like(r))
    lo = (r.double() + down.double()) * 0.5
    return torch.where((r > 0) & (x64 < lo * lo), down, r)


def ftrl_weights(z: torch.Tensor, n: torch.Tensor, *, alpha, beta, l1,
                 l2) -> torch.Tensor:
    """FTRL serve weights from ``(z, n)`` in ``FTRL._np_weights``' op
    order: ``denom = ((sqrt(n) + beta) / alpha) + l2``, ``w = (sign(z) *
    l1 - z) / denom``, +0 where ``|z| <= l1``. The hyper-parameters are
    floats or 0-dim float32 tensors on ``z``'s device."""
    a, b, c1, c2 = (p if isinstance(p, torch.Tensor) else _f32(p, z)
                    for p in (alpha, beta, l1, l2))
    denom = sqrt_rn(n) + b
    denom = denom / a
    denom = denom + c2
    w = torch.sign(z) * c1 - z
    w = w / denom
    return torch.where(z.abs() > c1, w, torch.zeros((), dtype=torch.float32,
                                                    device=z.device))


def ftrl_row_update(z: torch.Tensor, n: torch.Tensor, g: torch.Tensor, *,
                    alpha: float = 0.05, beta: float = 1.0, l1: float = 1.0,
                    l2: float = 1.0):
    """FTRL-proximal on (B, D) rows, float32: ``w`` from ``(z, n)``,
    ``n' = n + g*g``, ``sigma = (sqrt(n') - sqrt(n)) / alpha``,
    ``z' = (z + g) - sigma*w``, ``w'`` from ``(z', n')``. Returns
    ``(z', n', w')``, bit-equal to ``FTRL.update_rows(backend="numpy")``
    (square roots through ``sqrt_rn``)."""
    z, n, g = (t.to(torch.float32) for t in (z, n, g))
    p = {k: _f32(v, z) for k, v in
         (("alpha", alpha), ("beta", beta), ("l1", l1), ("l2", l2))}
    w_old = ftrl_weights(z, n, **p)
    n_new = n + g * g
    sigma = (sqrt_rn(n_new) - sqrt_rn(n)) / p["alpha"]
    z_new = (z + g) - sigma * w_old
    return z_new, n_new, ftrl_weights(z_new, n_new, **p)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8: ``scale = max(absmax * f32(1/127), 1e-12)``,
    ``q = clip(round_half_even(x / scale), -127, 127)``. ``x`` (B, D) ->
    ``(q int8 (B, D), scale float32 (B, 1))``."""
    x = x.to(torch.float32)
    s = torch.maximum(x.abs().amax(dim=-1, keepdim=True)
                      * _f32(1.0 / 127.0, x), _f32(1e-12, x))
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q`` int8 (B, D) times ``scale`` (B, 1) -> float32 (B, D)."""
    return q.to(torch.float32) * scale.to(torch.float32)


_NEG_INF = -1e30                    # the attention kernels' mask value


def _softmax_v(scores: torch.Tensor, v: torch.Tensor, eq: str) -> torch.Tensor:
    """``softmax(scores) . v`` as the attention kernels finish it: ``p =
    exp(s - max)``, ``l = sum(p)``, ``(p . v) / max(l, 1e-30)``, in
    float32."""
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum(eq, p, v.float()) / den


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """GQA attention with the flash kernel's arithmetic. q (B, H, S, D);
    k, v (B, G, T, D) with H = G * m, head h reading KV group h // m.
    Scores are ``(q * D^-0.5) . k`` in float32 (q scaled on float32
    values); causal masks key index > query index with -1e30; the softmax
    and P.V run in float32; the output is cast to ``q.dtype``."""
    b, h, s, d = q.shape
    g, t = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, g, h // g, s, d) * _f32(d ** -0.5, q)
    scores = torch.einsum("bgmsd,bgtd->bgmst", qf, k.float())
    if causal:
        keep = torch.ones((s, t), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, _NEG_INF)
    out = _softmax_v(scores, v, "bgmst,bgtd->bgmsd")
    return out.reshape(b, h, s, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """One query token per sequence against a KV cache, with the decode
    kernel's arithmetic. q (B, H, D); k, v (B, S, G, D); lengths (B,):
    cache rows ``>= lengths[b]`` score -1e30. Scores ``(q * D^-0.5) . k``,
    softmax and P.V in float32; the output (B, H, D) in ``q.dtype``."""
    b, h, d = q.shape
    s, g = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, g, h // g, d) * _f32(d ** -0.5, q)
    scores = torch.einsum("bgmd,bsgd->bgms", qf, k.float())
    valid = (torch.arange(s, device=q.device)[None, :]
             < lengths.to(q.device, torch.long)[:, None])
    scores = scores.masked_fill(~valid[:, None, None, :], _NEG_INF)
    out = _softmax_v(scores, v, "bgms,bsgd->bgmd")
    return out.reshape(b, h, d).to(q.dtype)
