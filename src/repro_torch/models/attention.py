"""Attention layers of the LM path: GQA self-attention (global,
sliding-window and bidirectional encoder) and cross attention for
prefill and training, and single-token decode against a KV cache or a
cross cache — the counterpart of the reference's ``models/attention.py``.

Where the reference's prefill calls an XLA analogue of the Pallas flash
kernel and its decode writes the attention inline, the port calls the
hand-written kernels through ``kernels.ops``: ``flash_attention`` for
causal layers whose window is void and ``decode_attention`` against a
full-precision cache. For these modes the analogues compute the kernels'
functions, so the results agree with the reference's within a stated
float32 tolerance. In bfloat16 the kernels round less than the
reference: they scale q on float32 values (the reference scales it in
the working dtype), and ``decode_attention`` keeps keys and
probabilities in float32 (the reference rounds keys to q's dtype and
probabilities to the cache's).

A sliding-window layer takes the reference's branches in its order:
block-local attention (``_block_local_causal``) when the window divides
S, a masked whole-row softmax (``_full_attention``) when S fits one
chunk, plain causal attention through the flash kernel when the window
is void (S <= window), and ``NotImplementedError`` where the reference
raises. The reference computes the two windowed branches in XLA
einsums, outside any Pallas kernel, so the port computes them in tensor
ops, differentiated by autograd. Its decode writes a ring of ``window``
rows at ``pos % window``; the ring's valid rows are always the prefix
``t < min(pos + 1, window)``, so ``decode_attention`` with those lengths
is the reference's masked softmax over the ring.

A bidirectional encoder layer (``causal=False``) and cross attention
(queries from the decoder, keys and values from the encoder's states,
no rotation) run the flash kernel without its causal mask, S and T
any lengths; the reference computes both in XLA einsums
(``_full_attention`` with an all-true mask), the same function. Decode
against the precomputed cross cache (``decode_cross_attention``) is
``decode_attention`` at lengths T, every row valid.

Training differentiates the flash path through ``_FlashAttention``: the
forward is the kernel, the backward the standard attention gradient in
plain tensor ops (the reference has no Pallas backward either: it trains
through XLA's autodiff of its einsum softmax). A cross layer's k and v
gradients flow back into the encoder's states.

The int8 KV cache (``k``, ``v`` int8 beside float32 ``k_scale``,
``v_scale`` of one absmax scale a (token, head) row) quantizes each new
row as the reference's jitted decode does (``_quantize_row``, tensor
ops in the row's dtype) and reads the cache through the
``dequantize_rows`` kernel before ``decode_attention``: values as
``f32(codes) * v_scale``, keys as the codes times ``k_scale`` rounded
to q's dtype, the product rounded to q's dtype — the reference's
``keys`` and ``values`` exactly (codes have 7 bits and a bf16 scale 8,
so the float32 product is exact). The reference reads the int8 cache
in its einsums; a ``decode_attention`` that reads int8 itself is later
device work.
A configuration without rotary embeddings (``cfg.use_rope`` False, a
NoPE model) skips ``rope`` in prefill and decode, and every path takes
its softmax scale from ``cfg.attention_scale`` (``hd ** -0.5`` unless
the configuration sets one): the flash forward, its float32 backward,
the windowed branches and decode attention.

The function boundaries keep the reference's layouts: x (B, S, D), q
(B, S, H, hd), cache (B, S_cache, Kv, hd).

With ``cfg.context_parallel_attn`` and a mesh in scope
(``common.mesh_scope``), ``_context_parallel_constraint`` lays q out
sequence-split on ``model`` and k, v replicated on it, as the
reference's hint does, through ``sharding.logical_axis_constraint``
(a ``DTensor`` redistribution; a plain tensor passes as it is). The
flash kernel's sharding rule then moves q to a batch or head split:
the kernel masks by index, so a query shard cannot take its offset.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import _build, ops
from repro_torch.models.common import current_mesh, rope

_NEG_INF = -1e30


def _mergeable(w: torch.Tensor, first: int) -> torch.Tensor:
    """``w`` ready to merge its dims from ``first`` on into one: a
    ``DTensor`` split on a dim after ``first`` is gathered on it (the
    merged dim could only be a strided split, which no matmul rule
    takes) — where the reference shards head_dim on ``model`` because the
    heads do not divide it. The QKV biases go through it too (``first``
    0), so that a head_dim-split bias does not split the projection's
    output, and with it the gradient its flattened matmul gets. A plain
    tensor as it is."""
    if not _build.dtensor_args(w):
        return w
    from torch.distributed.tensor import Replicate

    def keep(p) -> bool:
        d = _build.shard_dim(p)
        return p.is_replicate() or p.is_partial() or (d is not None
                                                      and d <= first)

    pl = [p if keep(p) else Replicate() for p in w.placements]
    if tuple(pl) == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, pl)


def _splittable(y: torch.Tensor, dim: int, outer: int) -> torch.Tensor:
    """``y`` ready to split its dim ``dim`` into (``outer``, rest): a
    ``DTensor`` split on that dim over a mesh dim whose size does not
    divide ``outer`` is gathered on it (the split would fall inside the
    inner factor). A plain tensor as it is."""
    if not _build.dtensor_args(y):
        return y
    from torch.distributed.tensor import Replicate
    mesh = y.device_mesh
    pl = [Replicate() if _build.shard_dim(p) == dim
          and outer % mesh.size(i) else p
          for i, p in enumerate(y.placements)]
    if tuple(pl) == tuple(y.placements):
        return y
    return y.redistribute(mesh, pl)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) through w (D, heads, hd): (B, S, heads, hd)."""
    b, s, d = x.shape
    y = _splittable(x @ _mergeable(w, 1).reshape(d, -1), 2, w.shape[1])
    return y.view(b, s, *w.shape[1:])


def project_kv(p: dict, src: torch.Tensor):
    """K and V projections of src (B, T, D): (B, T, Kv, hd) each, plus
    their biases where the layer has them."""
    k = _project(src, p["wk"])
    v = _project(src, p["wv"])
    if "bk" in p:
        k = k + _mergeable(p["bk"], 0)
        v = v + _mergeable(p["bv"], 0)
    return k, v


def project_qkv(p: dict, x: torch.Tensor, *,
                enc: Optional[torch.Tensor] = None):
    """Q from x (B, S, D): q (B, S, H, hd); K and V from ``enc`` (B, T, D)
    when it is given (cross attention), else from x: k and v (B, T, Kv,
    hd); plus the QKV biases where the layer has them."""
    q = _project(x, p["wq"])
    if "bq" in p:
        q = q + _mergeable(p["bq"], 0)
    return (q, *project_kv(p, enc if enc is not None else x))


def _out_proj(p: dict, out: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) attention output -> (B, S, D)."""
    b, s = out.shape[:2]
    wo = _mergeable(p["wo"], 0)
    out = _mergeable(out, 2).reshape(b, s, -1)
    return out @ wo.reshape(-1, wo.shape[-1])


class _FlashAttention(torch.autograd.Function):
    """GQA attention, causal or full: forward ``ops.flash_attention`` (the
    kernel), backward written out in float32 tensor ops — the counterpart
    of XLA's autodiff of the reference's softmax attention, computed
    outside any kernel. It recomputes the probabilities P from q and k
    (the kernel keeps none; ``causal`` keeps key index <= query index,
    else every key), then ``D = rowsum(dO * O)``, ``dS = P * (dP - D)``,
    and ``dq``, ``dk``, ``dv``, summing k's and v's over the heads of
    their group. q (B, H, S, hd); k, v (B, G, T, hd), T any length when
    not ``causal``; ``scale`` the softmax scale (``cfg.attention_scale``:
    ``hd ** -0.5`` unless the configuration sets one)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out = ops.flash_attention(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out = ctx.saved_tensors
        b, h, s, hd = q.shape
        g, t = k.shape[1], k.shape[2]
        scale = ctx.scale
        grouped = (b, g, h // g, s, hd)
        qf = q.float().reshape(grouped) * scale
        kf, vf = k.float(), v.float()
        scores = torch.einsum("bgmsd,bgtd->bgmst", qf, kf)
        if ctx.causal:
            keep = torch.ones((s, t), dtype=torch.bool,
                              device=q.device).tril()
            scores.masked_fill_(~keep, -1e30)
        p = torch.softmax(scores, dim=-1)
        del scores
        do = d_out.float().reshape(grouped)
        delta = (do * out.float().reshape(grouped)).sum(-1, keepdim=True)
        ds = torch.einsum("bgmsd,bgtd->bgmst", do, vf).sub_(delta).mul_(p)
        dv = torch.einsum("bgmst,bgmsd->bgtd", p, do)
        del p
        dq = torch.einsum("bgmst,bgtd->bgmsd", ds, kf).mul_(scale)
        dk = torch.einsum("bgmst,bgmsd->bgtd", ds, qf)
        return (dq.reshape(b, h, s, hd).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (b, s, g, m, e), k (b, t, g, e) -> (b, g, m, s, t) float32
    logits."""
    return torch.einsum("bsgme,btge->bgmst", q.float(), k.float())


def _full_attention(q, k, v, mask):
    """Direct attention over whole rows, the reference's
    ``_full_attention``: float32 scores, ``mask`` (b, 1, 1, s, t) keeps,
    the softmax in float32, the probabilities cast to v's dtype before
    the PV product. Returns (b, s, g, m, e)."""
    scores = torch.where(mask, _gqa_scores(q, k), _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bgmst,btge->bsgme", probs.to(v.dtype), v)


def _block_local_causal(q, k, v, q_positions, window: int):
    """Exact sliding-window attention by blocks of ``window`` rows, the
    reference's ``_block_local_causal``: query block i attends key blocks
    {i - 1, i} (block 0's previous block zeros, masked by ``kpos >= 0``),
    keys kept where ``qp >= kp`` and ``qp - kp < window``. q (b, s, g,
    m, e), k, v (b, s, g, e) with s a multiple of ``window``; returns
    (b, s, g, m, e)."""
    b, s, g, m, e = q.shape
    w = window
    nb = s // w
    qb = q.reshape(b, nb, w, g, m, e)
    kb = k.reshape(b, nb, w, g, e)
    vb = v.reshape(b, nb, w, g, e)
    k2 = torch.cat([torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], 1),
                    kb], dim=2)                          # (b, nb, 2w, g, e)
    v2 = torch.cat([torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], 1),
                    vb], dim=2)
    scores = torch.einsum("bnsgme,bntge->bngmst", qb.float(), k2.float())
    pos_b = q_positions.reshape(b, nb, w)
    kpos = torch.cat([pos_b - w, pos_b], dim=-1)         # (b, nb, 2w)
    qp = pos_b[:, :, None, None, :, None]
    kp = kpos[:, :, None, None, None, :]
    mask = (kp >= 0) & (qp >= kp) & (qp - kp < w)
    probs = torch.softmax(torch.where(mask, scores, _NEG_INF), dim=-1)
    out = torch.einsum("bngmst,bntge->bnsgme", probs.to(v2.dtype), v2)
    return out.reshape(b, s, g, m, e)


def _context_parallel_constraint(q, k, v):
    """Shard the query sequence over ``model``; keep K/V replicated
    across it (sequence/context parallelism), where a mesh with a
    ``model`` axis is in scope; else the identity."""
    m = current_mesh()
    if m is None or "model" not in m.axes:
        return q, k, v
    from repro_torch.models.sharding import P, logical_axis_constraint
    U = P.UNCONSTRAINED
    q = logical_axis_constraint(q, m, P(U, "model", None, None))
    k = logical_axis_constraint(k, m, P(U, None, None, None))
    v = logical_axis_constraint(v, m, P(U, None, None, None))
    return q, k, v


def _grouped(fn, q, k, v, positions):
    """``fn(q, k, v, positions)`` of the windowed branches: on plain
    tensors as it is; on ``DTensor``s on local shards (forward and
    backward), each mesh dim splitting the batch (positions with it)
    where q, k or v is split there or the batch divides, else the KV
    groups (q's dim 2, k's and v's dim 2) where they divide, else
    replicated — the einsums' (b, g) batch dims stay whole in a shard."""
    if not _build.dtensor_args(q, k, v):
        return fn(q, k, v, positions)
    from torch.distributed.tensor import Replicate, Shard
    mesh = _build.mesh_of(q, k, v)
    pls = [_build.placements_of(x, mesh) for x in (q, k, v)]
    b, g = q.shape[0], q.shape[2]
    ins = [[], [], [], []]
    for i, n in enumerate(mesh.shape):
        moved = any(not isinstance(p[i], Replicate) for p in pls)
        if n > 1 and (any(_build.shard_dim(p[i]) == 0 for p in pls)
                      or (moved and b % n == 0)):
            picks, b = (Shard(0),) * 4, -(-b // n)
        elif n > 1 and moved and g % n == 0:
            picks, g = (Shard(2),) * 3 + (Replicate(),), g // n
        else:
            picks = (Replicate(),) * 4
        for lst, pick in zip(ins, picks):
            lst.append(pick)
    ins = [tuple(x) for x in ins]
    return _build.local_map(fn, (q, k, v, positions), ins, ins[0], q.shape,
                            mesh)


def self_attention(p: dict, x: torch.Tensor, positions: torch.Tensor, *,
                   cfg: ModelConfig, causal: bool = True, window: int = 0,
                   chunk: int = 1024) -> torch.Tensor:
    """Prefill self-attention. x (B, S, D); positions (B, S) rotate q and
    k. A bidirectional encoder layer (``causal`` False) runs the flash
    kernel unmasked, at any positions (they only rotate). A causal
    layer is global (``window`` 0) or sliding-window; its branches are
    the reference's, in its order:

    * ``window`` divides S and S > window: block-local attention in
      tensor ops;
    * S <= ``chunk``: with a window under S, the masked whole-row
      softmax in tensor ops; otherwise (no window, or S <= window, where
      the window masks nothing) the flash kernel;
    * S > ``chunk``: the flash kernel for a global layer; a windowed one
      raises ``NotImplementedError``, as the reference does.

    The kernel masks a causal layer by index (key index > query index),
    so on its causal path the positions must be ``arange(S)`` on every
    row — ``models.model.forward`` passes nothing else."""
    b, s, _ = x.shape
    if not causal:              # the reference ignores a window there too
        window = 0
    blocked = bool(window) and s > window and s % window == 0
    masked = not blocked and bool(window) and window < s
    if window and not blocked and s > chunk:
        raise NotImplementedError(
            f"windowed attention requires s % window == 0 past one chunk "
            f"(s {s}, window {window}, chunk {chunk})")
    q, k, v = project_qkv(p, x)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if cfg.context_parallel_attn:
        q, k, v = _context_parallel_constraint(q, k, v)
    if blocked or masked:
        g, hd = cfg.num_kv_heads, cfg.head_dim
        q = (q * cfg.attention_scale).reshape(b, s, g, cfg.num_heads // g,
                                              hd)
        if blocked:
            out = _grouped(lambda q_, k_, v_, p_: _block_local_causal(
                q_, k_, v_, p_, window), q, k, v, positions)
        else:
            def masked_attention(q_, k_, v_, p_):
                qp, kp = p_[:, None, None, :, None], p_[:, None, None, None, :]
                return _full_attention(q_, k_, v_,
                                       (qp >= kp) & (qp - kp < window))
            out = _grouped(masked_attention, q, k, v, positions)
        return _out_proj(p, out.reshape(b, s, cfg.num_heads, hd))
    return _flash(p, q, k, v, causal=causal, scale=cfg.attention_scale)


def _flash(p: dict, q, k, v, *, causal: bool, scale: float) -> torch.Tensor:
    """q (B, S, H, hd), k, v (B, T, Kv, hd), unscaled, through the flash
    kernel (``_FlashAttention``, softmax scale ``scale``) and the output
    projection: (B, S, D)."""
    # the kernel's (B, H, S, hd) / (B, Kv, T, hd) as transposed views: it
    # takes strides, and writes its output in q's (B, S, H, hd) layout
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if _build.dtensor_args(q, k, v):
        # forward and backward on the shards the kernel's rule picks
        from repro_torch.kernels.flash_attention import shard_plan
        ins, out_pl, mesh = shard_plan(q, k, v)
        out = _build.local_map(
            lambda q_, k_, v_: _FlashAttention.apply(q_, k_, v_, causal,
                                                     scale),
            (q, k, v), ins, out_pl, q.shape, mesh)
    else:
        out = _FlashAttention.apply(q, k, v, causal, scale)
    return _out_proj(p, out.transpose(1, 2))


def cross_attention(p: dict, x: torch.Tensor, enc: torch.Tensor, *,
                    cfg: ModelConfig) -> torch.Tensor:
    """Cross attention: queries from x (B, S, D), keys and values from the
    encoder's states ``enc`` (B, T, D); no rotation on the cross path, as
    in the reference. Every query attends every frame: the flash kernel
    unmasked at S against T."""
    q, k, v = project_qkv(p, x, enc=enc)
    return _flash(p, q, k, v, causal=False, scale=cfg.attention_scale)


def _quantize_row(x: torch.Tensor):
    """(B, Kv, hd) -> int8 codes and (B, Kv, 1) float32 absmax scales, the
    reference's ``_quantize_row`` as its jitted decode computes it: the
    absmax clamped at 1e-6 in x's dtype, ``scale = f32(absmax) * f32(1 /
    127)`` (XLA folds the constant division ``/ 127.0`` into that
    multiply, and keeps a bf16 x's scale in float32 where it is
    returned; JAX's op-by-op dispatch divides and rounds to x's dtype),
    ``codes = clip(round_half_even(x / scale), -127, 127)`` in x's dtype,
    on the scale rounded to it."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6).float() \
        * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / scale.to(x.dtype)), -127, 127)
    return q.to(torch.int8), scale


def _dequantize(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 ``codes`` (..., hd) times ``scale`` (..., 1) through the
    ``dequantize_rows`` kernel, one row an hd: float32 of codes' shape.
    On ``DTensor``s each shard reads its own rows (a split head dim is
    gathered first): the rows are independent."""
    if _build.dtensor_args(codes, scale):
        from torch.distributed.tensor import Replicate
        mesh = _build.mesh_of(codes, scale)
        pc = tuple(p if p.is_replicate() or _build.shard_dim(p) in range(
            codes.dim() - 1) else Replicate()
            for p in _build.placements_of(codes, mesh))
        return _build.local_map(_dequantize, (codes, scale), [pc, pc], pc,
                                codes.shape, mesh)
    hd = codes.shape[-1]
    return ops.dequantize_rows(codes.reshape(-1, hd),
                               scale.reshape(-1, 1)).view(codes.shape)


def _write_rows(buf: torch.Tensor, bidx: torch.Tensor, slot: torch.Tensor,
                rows: torch.Tensor) -> None:
    """``buf[bidx, slot] = rows`` IN PLACE: each sequence b's new row of a
    (B, S, ...) cache buffer, ``bidx`` = ``arange(B)``. On a ``DTensor``
    buffer each shard writes the rows in its (batch, sequence) range
    (``_write_rows_sharded``; ``bidx`` unused)."""
    if not _build.dtensor_args(buf):
        buf[bidx, slot] = rows
        return
    _write_rows_sharded(buf, slot, rows)


def _write_rows_sharded(buf, slot, rows) -> None:
    """The cache write on a ``DTensor`` buffer split on batch and sequence
    (and heads or head dim): ``slot`` and ``rows`` follow the buffer's
    batch split (``rows`` its other splits too) and are replicated over
    the sequence split; each shard rewrites its (b, slot - offset) row
    with the new row where the slot falls in its range and with its own
    row elsewhere (a data-independent write)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = buf.device_mesh
    pb = buf.placements
    ps, pr = [], []
    for p in pb:
        d = _build.shard_dim(p)
        if d == 0:
            ps.append(Shard(0))
            pr.append(Shard(0))
        elif d is not None and d >= 2:
            ps.append(Replicate())
            pr.append(Shard(d - 1))
        elif d == 1 or p.is_replicate():
            ps.append(Replicate())
            pr.append(Replicate())
        else:
            raise ValueError(f"a cache write cannot take a buffer placed "
                             f"{p}")
    size, offset = _build.local_extent(buf.shape, mesh, pb)

    def fn(buf_, slot_, rows_):
        rel = slot_ - offset[1]
        ok = (rel >= 0) & (rel < size[1])
        rel = torch.where(ok, rel, 0)
        bidx = torch.arange(buf_.shape[0], device=buf_.device)
        keep = ok.view(-1, *([1] * (rows_.dim() - 1)))
        buf_[bidx, rel] = torch.where(keep, rows_.to(buf_.dtype),
                                      buf_[bidx, rel])

    _build.local_map(fn, (buf, slot, rows), [tuple(pb), tuple(ps),
                                              tuple(pr)], None, None, mesh)


def decode_self_attention(p: dict, x: torch.Tensor, pos: torch.Tensor,
                          cache: dict, *, cfg: ModelConfig,
                          window: int = 0):
    """One-token decode. x (B, 1, D); pos (B,) positions of the new token;
    cache ``{"k", "v": (B, S_cache, Kv, hd)}`` in float32 or bfloat16, or
    int8 with ``{"k_scale", "v_scale": (B, S_cache, Kv, 1)}`` float32
    (the int8 cache: the new rows quantized by ``_quantize_row``, the
    cache read through ``_dequantize`` into keys in q's dtype and
    float32 values, as the reference reads it).

    A global layer (``window`` 0) writes the new K/V row at ``pos``, each
    in ``[0, S_cache)``, and attends over ``pos + 1`` rows. A windowed
    layer's cache is a ring of ``window`` rows (``S_cache`` must be
    ``window``): the row goes to ``pos % window`` and the kernel attends
    over the first ``min(pos + 1, window)`` rows, the ring's valid ones
    (every key keeps the rotation of its absolute position, and a
    softmax over a set does not depend on its order). The row is written
    IN PLACE (the reference returns a new cache; its jitted step donates
    the old one). Returns ``(out (B, 1, D), cache)``, the cache dict
    being the one passed in.
    """
    b = x.shape[0]
    cache_k, cache_v = cache["k"], cache["v"]
    if window and cache_k.shape[1] != window:
        raise ValueError(f"a windowed layer decodes against a ring of "
                         f"window = {window} rows, not {cache_k.shape[1]}")
    q, k, v = project_qkv(p, x)
    if cfg.use_rope:
        q = rope(q, pos[:, None], cfg.rope_theta)
        k = rope(k, pos[:, None], cfg.rope_theta)
    bidx, slot = torch.arange(b, device=x.device), pos.long()
    if window:
        slot = slot % window
    if "k_scale" in cache:
        k_scale, v_scale = cache["k_scale"], cache["v_scale"]
        for buf, scale, new in ((cache_k, k_scale, k), (cache_v, v_scale, v)):
            codes, sc = _quantize_row(new[:, 0])
            _write_rows(buf, bidx, slot, codes)
            _write_rows(scale, bidx, slot, sc)
        keys = _dequantize(cache_k, k_scale.to(q.dtype)).to(q.dtype)
        cache_k, cache_v = keys.float(), _dequantize(cache_v, v_scale)
    else:
        _write_rows(cache_k, bidx, slot, k[:, 0].to(cache_k.dtype))
        _write_rows(cache_v, bidx, slot, v[:, 0].to(cache_v.dtype))
    lengths = torch.clamp(pos + 1, max=window) if window else pos + 1
    out = ops.decode_attention(q[:, 0], cache_k, cache_v, lengths,
                               cfg.attention_scale)
    return _out_proj(p, out[:, None].to(x.dtype)), cache


def decode_cross_attention(p: dict, x: torch.Tensor, xk: torch.Tensor,
                           xv: torch.Tensor, *,
                           cfg: ModelConfig) -> torch.Tensor:
    """Decode-time cross attention of x (B, 1, D) against the precomputed
    encoder K/V ``xk``, ``xv`` (B, T, Kv, hd), read-only during decode:
    q without rotation, through ``decode_attention`` over all T rows
    (the kernel scales q). Returns (B, 1, D)."""
    b, t = xk.shape[:2]
    q = _project(x, p["wq"])
    if "bq" in p:
        q = q + _mergeable(p["bq"], 0)
    lengths = torch.full((b,), t, dtype=torch.int32, device=x.device)
    out = ops.decode_attention(q[:, 0], xk, xv, lengths, cfg.attention_scale)
    return _out_proj(p, out[:, None].to(x.dtype))
