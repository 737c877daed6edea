"""Attention layers of the LM serving path: GQA self-attention (global
and sliding-window) for prefill and single-token decode against a KV
cache — the counterpart of the reference's ``models/attention.py``.

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

Training differentiates the flash path through ``_FlashAttention``: the
forward is the kernel, the backward the standard attention gradient in
plain tensor ops (the reference has no Pallas backward either: it trains
through XLA's autodiff of its einsum softmax).

Bidirectional-encoder and cross attention and the int8 KV cache are not
ported yet and raise ``NotImplementedError``. The function boundaries
keep the reference's layouts: x (B, S, D), q (B, S, H, hd), cache (B,
S_cache, Kv, hd).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import rope

_NEG_INF = -1e30


def project_qkv(p: dict, x: torch.Tensor):
    """Q, K, V projections of x (B, S, D): q (B, S, H, hd), k and v
    (B, S, Kv, hd), plus the QKV biases where the layer has them."""
    b, s, d = x.shape
    q = (x @ p["wq"].reshape(d, -1)).view(b, s, *p["wq"].shape[1:])
    k = (x @ p["wk"].reshape(d, -1)).view(b, s, *p["wk"].shape[1:])
    v = (x @ p["wv"].reshape(d, -1)).view(b, s, *p["wv"].shape[1:])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _out_proj(p: dict, out: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) attention output -> (B, S, D)."""
    b, s = out.shape[:2]
    return out.reshape(b, s, -1) @ p["wo"].reshape(-1, p["wo"].shape[-1])


class _FlashAttention(torch.autograd.Function):
    """Causal GQA attention: forward ``ops.flash_attention`` (the
    kernel), backward written out in float32 tensor ops — the counterpart
    of XLA's autodiff of the reference's softmax attention, computed
    outside any kernel. It recomputes the probabilities P from q and k
    (the kernel keeps none), then ``D = rowsum(dO * O)``, ``dS = P * (dP -
    D)``, and ``dq``, ``dk``, ``dv``, summing k's and v's over the heads
    of their group. q (B, H, S, hd); k, v (B, G, T, hd)."""

    @staticmethod
    def forward(ctx, q, k, v):
        out = ops.flash_attention(q, k, v, causal=True)
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out = ctx.saved_tensors
        b, h, s, hd = q.shape
        g, t = k.shape[1], k.shape[2]
        scale = hd ** -0.5
        grouped = (b, g, h // g, s, hd)
        qf = q.float().reshape(grouped) * scale
        kf, vf = k.float(), v.float()
        scores = torch.einsum("bgmsd,bgtd->bgmst", qf, kf)
        keep = torch.ones((s, t), dtype=torch.bool, device=q.device).tril()
        p = torch.softmax(scores.masked_fill_(~keep, -1e30), dim=-1)
        del scores
        do = d_out.float().reshape(grouped)
        delta = (do * out.float().reshape(grouped)).sum(-1, keepdim=True)
        ds = torch.einsum("bgmsd,bgtd->bgmst", do, vf).sub_(delta).mul_(p)
        dv = torch.einsum("bgmst,bgmsd->bgtd", p, do)
        del p
        dq = torch.einsum("bgmst,bgtd->bgmsd", ds, kf).mul_(scale)
        dk = torch.einsum("bgmst,bgmsd->bgtd", ds, qf)
        return (dq.reshape(b, h, s, hd).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype))


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


def self_attention(p: dict, x: torch.Tensor, positions: torch.Tensor, *,
                   cfg: ModelConfig, causal: bool = True, window: int = 0,
                   chunk: int = 1024) -> torch.Tensor:
    """Prefill self-attention of a causal layer, global (``window`` 0) or
    sliding-window. x (B, S, D); positions (B, S) rotate q and k. The
    branches are the reference's, in its order:

    * ``window`` divides S and S > window: block-local attention in
      tensor ops;
    * S <= ``chunk``: with a window under S, the masked whole-row
      softmax in tensor ops; otherwise (no window, or S <= window, where
      the window masks nothing) the flash kernel;
    * S > ``chunk``: the flash kernel for a global layer; a windowed one
      raises ``NotImplementedError``, as the reference does.

    The kernel masks by index (key index > query index), so on its path
    the positions must be ``arange(S)`` on every row —
    ``models.model.forward`` passes nothing else."""
    if not causal:
        raise NotImplementedError("bidirectional encoder attention is not "
                                  "ported yet")
    b, s, _ = x.shape
    blocked = bool(window) and s > window and s % window == 0
    masked = not blocked and bool(window) and window < s
    if window and not blocked and s > chunk:
        raise NotImplementedError(
            f"windowed attention requires s % window == 0 past one chunk "
            f"(s {s}, window {window}, chunk {chunk})")
    q, k, v = project_qkv(p, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if blocked or masked:
        g, hd = cfg.num_kv_heads, cfg.head_dim
        q = (q * (hd ** -0.5)).reshape(b, s, g, cfg.num_heads // g, hd)
        if blocked:
            out = _block_local_causal(q, k, v, positions, window)
        else:
            qp, kp = positions[:, None, None, :, None], \
                positions[:, None, None, None, :]
            out = _full_attention(q, k, v, (qp >= kp) & (qp - kp < window))
        return _out_proj(p, out.reshape(b, s, cfg.num_heads, hd))
    # the kernel's (B, H, S, hd) / (B, Kv, T, hd) as transposed views: it
    # takes strides, and writes its output in q's (B, S, H, hd) layout
    out = _FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2))
    return _out_proj(p, out.transpose(1, 2))


def decode_self_attention(p: dict, x: torch.Tensor, pos: torch.Tensor,
                          cache: dict, *, cfg: ModelConfig,
                          window: int = 0):
    """One-token decode. x (B, 1, D); pos (B,) positions of the new token;
    cache ``{"k", "v": (B, S_cache, Kv, hd)}`` in float32 or bfloat16.

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
    if "k_scale" in cache:
        raise NotImplementedError("the int8 KV cache is not ported yet")
    b = x.shape[0]
    cache_k, cache_v = cache["k"], cache["v"]
    if window and cache_k.shape[1] != window:
        raise ValueError(f"a windowed layer decodes against a ring of "
                         f"window = {window} rows, not {cache_k.shape[1]}")
    q, k, v = project_qkv(p, x)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)
    bidx, slot = torch.arange(b, device=x.device), pos.long()
    if window:
        slot = slot % window
    cache_k[bidx, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, slot] = v[:, 0].to(cache_v.dtype)
    lengths = torch.clamp(pos + 1, max=window) if window else pos + 1
    out = ops.decode_attention(q[:, 0], cache_k, cache_v, lengths)
    return _out_proj(p, out[:, None].to(x.dtype)), cache
