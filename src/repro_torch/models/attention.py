"""Attention layers of the LM serving path: GQA self-attention for prefill
and single-token decode against a KV cache — the counterpart of the
reference's ``models/attention.py``.

Where the reference's prefill calls an XLA analogue of the Pallas flash
kernel and its decode writes the attention inline, the port calls the
hand-written kernels through ``kernels.ops``: ``flash_attention`` for
global causal layers and ``decode_attention`` against a full-precision
cache. For these modes the analogues compute the kernels' functions, so
the results agree with the reference's within a stated float32 tolerance.
In bfloat16 the kernels round less than the reference: they scale q on
float32 values (the reference scales it in the working dtype), and
``decode_attention`` keeps keys and probabilities in float32 (the
reference rounds keys to q's dtype and probabilities to the cache's).

Training differentiates ``self_attention`` through ``_FlashAttention``:
the forward is the kernel, the backward the standard attention gradient
in plain tensor ops (the reference has no Pallas backward either: it
trains through XLA's autodiff of its einsum softmax).

Windowed, bidirectional-encoder and cross attention and the int8 KV cache
are not ported yet and raise ``NotImplementedError``. The function
boundaries keep the reference's layouts: x (B, S, D), q (B, S, H, hd),
cache (B, S_cache, Kv, hd).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import rope


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


def self_attention(p: dict, x: torch.Tensor, positions: torch.Tensor, *,
                   cfg: ModelConfig, causal: bool = True,
                   window: int = 0) -> torch.Tensor:
    """Prefill self-attention of a global causal layer. x (B, S, D);
    positions (B, S) rotate q and k. The kernel masks by index (key index
    > query index), so the positions must be ``arange(S)`` on every row —
    ``models.model.forward`` passes nothing else."""
    if not causal:
        raise NotImplementedError("bidirectional encoder attention is not "
                                  "ported yet")
    if window:
        raise NotImplementedError("sliding-window attention is not ported "
                                  "yet")
    q, k, v = project_qkv(p, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    # the kernel's (B, H, S, hd) / (B, Kv, T, hd) as transposed views: it
    # takes strides, and writes its output in q's (B, S, H, hd) layout
    out = _FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2))
    return _out_proj(p, out.transpose(1, 2))


def decode_self_attention(p: dict, x: torch.Tensor, pos: torch.Tensor,
                          cache: dict, *, cfg: ModelConfig,
                          window: int = 0):
    """One-token decode of a global layer. x (B, 1, D); pos (B,) positions
    of the new token, each in ``[0, S_cache)``; cache ``{"k", "v": (B,
    S_cache, Kv, hd)}`` in float32 or bfloat16.

    The new K/V row is written at ``pos`` IN PLACE (the reference returns
    a new cache; its jitted step donates the old one), then the kernel
    attends over ``pos + 1`` rows. Returns ``(out (B, 1, D), cache)``,
    the cache dict being the one passed in.
    """
    if window:
        raise NotImplementedError("sliding-window (ring-buffer) decode is "
                                  "not ported yet")
    if "k_scale" in cache:
        raise NotImplementedError("the int8 KV cache is not ported yet")
    b = x.shape[0]
    cache_k, cache_v = cache["k"], cache["v"]
    q, k, v = project_qkv(p, x)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)
    bidx, slot = torch.arange(b, device=x.device), pos.long()
    cache_k[bidx, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, slot] = v[:, 0].to(cache_v.dtype)
    out = ops.decode_attention(q[:, 0], cache_k, cache_v, pos + 1)
    return _out_proj(p, out[:, None].to(x.dtype)), cache
