"""Mixture-of-Experts FFN with capacity-based dispatch — the counterpart of
the reference's ``models/moe.py`` — and, for the port's own
architectures, dropless dispatch over the experts a card holds, beside a
shared expert.

Routing (``route``) is the reference's: float32 logits, a softmax, the
top k (``torch.topk``, sorted descending as ``jax.lax.top_k``), gates
normalised by ``max(sum, 1e-9)`` and the Switch load-balance aux loss.
The renormalised top k of the softmax equal the softmax over the top k
logits (HF's granitemoe gating): both are ``exp(l_i) / sum_top exp(l_j)``.
Slot ranks (``_slot_positions``) come from a stable sort by expert:
first come, first served in ``(token, k)`` order, so a full expert drops
the same assignments as the reference's, and an assignment is kept when
its rank is under the capacity (``moe_capacity``).

Row movement goes through the port's row kernels (``common.gather_rows``:
``embedding_lookup`` forward, ``embedding_scatter_add`` backward):

  * the dispatch is a gather through the inverse of the slot map: each
    row of the (E, C, D) buffer takes its token's row, or a zero row
    appended to the tokens for an empty slot. Kept (expert, slot) pairs
    are unique and the reference's buffer starts at zero, so this equals
    its ``.at[flat_e, slot_c].add``;
  * the combine gathers each assignment's row of the experts' output,
    scales it by its gate (0 for a dropped assignment) and sums a token's
    k rows in the reference's order: adds onto zeros, j = 0 … k-1.

The slot map, the inverse map and the counts are index arithmetic on the
sort (no scatter-add, no atomics): two calls agree to the bit, and a
remat recompute takes the same routes. Nothing reads back to the host.
The expert products stay ``torch.bmm``, as the reference's are XLA
einsums outside any Pallas kernel.

``cfg.moe_dispatch_groups = G > 1`` (with T divisible by G) is the
reference's group-local dispatch: capacity and slot ranks per group of
T/G consecutive tokens. Here the groups' buffers sit side by side in one
(E, G*C, D) buffer, ranked by a stable sort on the key ``g * E +
expert``, so one gather, one batched product a weight and one combine
serve all groups. The reference's ``_maybe_wsc`` sharding hints on the
grouped buffers become ``_maybe_wsc`` on the port's layout, inert
without a mesh in scope: the (E, G*C, D) buffers and expert outputs
experts on ``model`` and group slots on ``data`` (the reference's (G,
E, C, D) on ``(data, model)``), the combined (T, D) tokens on ``data``.

Dropless dispatch (``cfg.moe_dropless``; ``_dropless``) computes every
assignment routed to the experts the layer holds, ``[0,
cfg.held_experts)`` of the router's ``num_experts`` (a card's share
under expert parallelism; the router keeps its full width and top k).
It sorts the assignments by expert (``_expert_order``); held experts come
first, each a contiguous segment whose bounds stay on the device. The
first ``T * min(k, held)`` sorted assignments, the most that can be
held, are gathered through ``gather_rows`` into one buffer; each weight
is one grouped product over the held segments (``torch._grouped_mm``,
bf16 on the card; its work stops at the last held row), which leaves
the rows past the last segment unwritten. Those rows, the assignments
of absent experts, read and write their token's spare row (row T + i
for token i), which the scatter's output drops: their part of the
result is left out, with no stand-in for the cards that hold them, and
their gradients reach no token, gate or weight. The gates scale the
gated hidden rows before the down product (the same function as
scaling its output, on 768-wide rows instead of D-wide ones), and
``scatter_rows`` adds each token's rows into the output, in sorted
order. Nothing is read back to the host, so a decode step still
captures into a CUDA graph. A shared gated-SiLU expert
(``cfg.shared_expert_ff``) runs on every token beside the routed ones
and its output is added to theirs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import _build
from repro_torch.models.common import current_mesh, gather_rows, scatter_rows


def _maybe_wsc(x: torch.Tensor, *axes) -> torch.Tensor:
    """Sharding constraint if a mesh is in scope (the dry-run sets one),
    through ``sharding.logical_axis_constraint``; the identity
    otherwise. Axes the mesh lacks are dropped, as in the reference."""
    m = current_mesh()
    if m is None:
        return x
    from repro_torch.models.sharding import P, logical_axis_constraint
    spec = P(*[a if (a is None or a in m.axes) else None for a in axes])
    return logical_axis_constraint(x, m, spec)


def moe_capacity(num_tokens: int, cfg: ModelConfig) -> int:
    cap = cfg.moe_capacity_factor * num_tokens * cfg.experts_per_token
    cap = int(math.ceil(cap / cfg.num_experts))
    return max(8, -(-cap // 8) * 8)  # round up to a multiple of 8


def _topk(probs: torch.Tensor, k: int):
    """``torch.topk(probs, k, dim=-1)``; on a ``DTensor`` on each shard's
    rows (the experts gathered first): DTensor's cached rule for
    ``topk`` does not key on ``k``, so two models' routings would share
    an output shape."""
    if not _build.dtensor_args(probs):
        return torch.topk(probs, k, dim=-1)
    from torch.distributed.tensor import Replicate
    mesh = probs.device_mesh
    pl = tuple(p if _build.shard_dim(p) == 0 else Replicate()
               for p in probs.placements)
    shape = (probs.shape[0], k)
    return _build.local_map(lambda p_: torch.topk(p_, k, dim=-1), (probs,),
                            [pl], [pl, pl], [shape, shape], mesh)


def route(router_w: torch.Tensor, x: torch.Tensor, cfg: ModelConfig):
    """x (T, D) -> (expert_idx (T, k) int64, combine gates (T, k) float32,
    aux_loss scalar float32)."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _topk(probs, cfg.experts_per_token)              # (T, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance aux loss
    me = probs.mean(dim=0)                                       # (E,)
    ce = F.one_hot(idx[:, 0], cfg.num_experts).float().mean(dim=0)
    aux = cfg.num_experts * torch.sum(me * ce)
    return idx, gate, aux


def _expert_order(flat_e: torch.Tensor, num_experts: int):
    """The stable sort of the assignments by expert: ``(order, sorted_e,
    starts)`` with ``starts[e]`` the first sorted position of expert
    ``e`` (the end of the sort for an expert nobody chose)."""
    sorted_e, order = torch.sort(flat_e, stable=True)
    starts = torch.searchsorted(sorted_e, torch.arange(
        num_experts, dtype=sorted_e.dtype, device=flat_e.device))
    return order, sorted_e, starts


def _ranks(order, sorted_e, starts) -> torch.Tensor:
    tk = order.shape[0]
    ranks_sorted = torch.arange(tk, dtype=torch.int32,
                                device=order.device) \
        - starts[sorted_e].to(torch.int32)
    out = torch.empty(tk, dtype=torch.int32, device=order.device)
    out[order] = ranks_sorted                 # a permutation: no duplicates
    return out


def _slot_positions(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Rank of each (token, k) assignment within its expert, first come,
    first served in the original order (int32)."""
    return _ranks(*_expert_order(flat_e, num_experts))


def _dispatch(xt: torch.Tensor, idx: torch.Tensor, cap: int,
              cfg: ModelConfig, groups: int = 1):
    """xt (T, D); idx (T, k); ``groups`` groups of T / groups consecutive
    tokens, each with ``cap`` slots an expert -> ``(buf (E, groups * cap,
    D), rows (T*k,) the buffer row of each assignment (slot 0 of its
    expert when dropped), keep (T*k,) bool, counts (E,) int32 kept
    assignments)``. Buffer row ``e * groups * cap + g * cap + c`` is
    group g's slot c of expert e."""
    t, d = xt.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    tk, dev = t * k, xt.device
    flat_e = idx.reshape(-1)
    if _build.dtensor_args(flat_e):
        # the slot arithmetic on the whole routing, replicated (a sort and
        # a search over every assignment; DTensor has no rule for
        # ``searchsorted``)
        flat_e = flat_e.full_tensor()
    grp = torch.arange(tk, device=dev) // (tk // groups)
    key = grp * e + flat_e                      # (group, expert)
    order, sorted_key, starts = _expert_order(key, groups * e)
    slot = _ranks(order, sorted_key, starts)
    keep = slot < cap
    rows = flat_e * (groups * cap) + grp * cap + torch.where(keep, slot, 0)
    # the inverse map: slot c of (g, e) holds sorted assignment
    # starts[g, e] + c when (g, e) has more than c assignments
    n_key = torch.cat([starts[1:], starts.new_full((1,), tk)]) - starts
    first = starts.view(groups, e).T[:, :, None]             # (E, G, 1)
    c = torch.arange(cap, device=dev)
    src = torch.where(c < n_key.view(groups, e).T[:, :, None],
                      order[(first + c).clamp_max(tk - 1)] // k, t)
    xt0 = torch.cat([xt, xt.new_zeros((1, d))])             # row t: zeros
    buf = gather_rows(xt0, src.reshape(-1)).view(e, groups * cap, d)
    # on a mesh, experts on ``model``: a real redistribution, so the
    # gradient comes back replicated before the view's backward (a split
    # (E, C') flattened would give a strided split no rule takes)
    buf = _maybe_wsc(buf, "model", None, None)
    counts = n_key.clamp_max(cap).view(groups, e).sum(0).to(torch.int32)
    return buf, rows, keep, counts


def _combine(out_buf: torch.Tensor, rows: torch.Tensor, keep: torch.Tensor,
             gate: torch.Tensor, t: int) -> torch.Tensor:
    """out_buf (E, C', D) -> (T, D): each assignment's row times its gate
    (0 when dropped), a token's k rows added onto zeros in order j = 0 …
    k-1, as the reference's scatter-add runs them."""
    d = out_buf.shape[-1]
    # a DTensor buffer replicated first: flattening a split (E, C') would
    # give a strided split no rule takes
    out_buf = _maybe_wsc(out_buf, None, None, None)
    picked = gather_rows(out_buf.reshape(-1, d), rows)         # (T*k, D)
    picked = picked * (gate.reshape(-1, 1)
                       * keep[:, None]).to(picked.dtype)
    picked = picked.view(t, -1, d)
    out = torch.zeros((t, d), dtype=picked.dtype, device=picked.device)
    for j in range(picked.shape[1]):
        out = out + picked[:, j]
    return out


def _grouped(a: torch.Tensor, w: torch.Tensor,
             bounds: torch.Tensor) -> torch.Tensor:
    """Rows ``[bounds[g], bounds[g + 1])`` of ``a`` times ``w[g]``: one
    ``torch._grouped_mm`` over the segments, whose ends stay on the
    device. Rows from ``bounds[-1]`` on are left unwritten, in the
    product and in its input gradient alike."""
    return torch._grouped_mm(a, w, bounds[1:])


def _dropless(p: dict, xt: torch.Tensor, idx: torch.Tensor,
              gate: torch.Tensor, cfg: ModelConfig):
    """Every assignment to a held expert, computed: xt (T, D), idx and
    gate (T, k) -> (out (T, D), counts (held,) int32 rows a held expert
    took)."""
    t = xt.shape[0]
    k, held = cfg.experts_per_token, cfg.held_experts
    order, _, bounds = _expert_order(idx.reshape(-1), held + 1)
    bounds = bounds.to(torch.int32)        # held expert g: [bounds[g], [g+1])
    pick = order[:t * min(k, held)]
    live = torch.arange(pick.shape[0], device=xt.device) < bounds[-1]
    # a row past the held segments reads and writes its token's spare row
    # t + i, dropped after the scatter: the products leave such rows
    # unwritten, so neither they nor their gradients reach a token
    tok = pick // k + torch.where(live, 0, t)
    buf = gather_rows(torch.cat([xt, torch.zeros_like(xt)]), tok)
    h = F.silu(_grouped(buf, p["w_gate"], bounds)) \
        * _grouped(buf, p["w_up"], bounds)
    h = h * torch.where(live, gate.reshape(-1)[pick], 0)[:, None].to(h.dtype)
    out = scatter_rows(_grouped(h, p["w_down"], bounds), tok, 2 * t)[:t]
    return out, bounds[1:] - bounds[:-1]


def _shared_expert(p: dict, xt: torch.Tensor) -> torch.Tensor:
    return (F.silu(xt @ p["w_gate"]) * (xt @ p["w_up"])) @ p["w_down"]


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, D) -> (out (B, S, D), aux_loss float32 scalar,
    expert_counts int32: (E,) kept assignments, or with dropless
    dispatch (held,) assignments routed to each held expert).

    ``p``: ``router`` (D, E), ``w_gate`` and ``w_up`` (E', D, F),
    ``w_down`` (E', F, D) with E' the held experts, and with a shared
    expert ``shared`` (``w_gate``, ``w_up`` (D, F_s), ``w_down`` (F_s,
    D)). ``expert_counts`` feeds the WeiPS sync engine (touched-expert
    ids)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    idx, gate, aux = route(p["router"], xt, cfg)
    if cfg.moe_dropless:
        out, counts = _dropless(p, xt, idx, gate, cfg)
        if cfg.shared_expert_ff:
            out = out + _shared_expert(p["shared"], xt)
        return out.reshape(b, s, d), aux, counts
    g = max(1, cfg.moe_dispatch_groups)
    groups = g if g > 1 and t % g == 0 else 1
    cap = moe_capacity(t // groups, cfg)
    buf, rows, keep, counts = _dispatch(xt, idx, cap, cfg, groups)
    if groups > 1:
        buf = _maybe_wsc(buf, "model", "data", None)
    h_gate, h_up = torch.bmm(buf, p["w_gate"]), torch.bmm(buf, p["w_up"])
    if groups > 1:
        h_gate = _maybe_wsc(h_gate, "model", "data", None)
        h_up = _maybe_wsc(h_up, "model", "data", None)
    h = F.silu(h_gate) * h_up
    out_buf = torch.bmm(h, p["w_down"])
    if groups > 1:
        out_buf = _maybe_wsc(out_buf, "model", "data", None)
    out = _combine(out_buf, rows, keep, gate, t)
    if groups > 1:
        out = _maybe_wsc(out, "data", None)
    return out.reshape(b, s, d), aux, counts
