"""LM composition for the serving path: parameter init, full-sequence
forward (prefill) and single-token decode — the counterpart of the
reference's ``models/model.py`` for dense ``ATTN`` + ``MLP`` stacks.

Parameters are a plain dict with the reference's nesting (``embed``,
``final_norm``, ``segments[i]["pos{j}"]["mixer" | "ffn"]``, ``lm_head``
when the head is untied), each layer leaf stacked on a leading
``repeats`` axis. The reference scans that axis with ``jax.lax.scan``;
the port loops over it in Python, one layer's views at a time.

MoE and Mamba layers, sliding-window, encoder and cross attention, and
encoder-decoder or frontend-context models raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ATTN, MLP, ModelConfig, Segment
from repro_torch.core.ps import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import dense_init, rms_norm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r} is not one of {sorted(_DTYPES)}")
    return _DTYPES[name]


def _check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for any part of ``cfg`` the port does
    not run yet."""
    for seg in cfg.segments:
        for spec in seg.pattern:
            if spec.mixer != ATTN or spec.ffn != MLP:
                raise NotImplementedError(
                    f"{cfg.name}: layer ({spec.mixer}, {spec.ffn}) is not "
                    f"ported yet; the port runs ({ATTN}, {MLP}) layers")
    if cfg.encoder_segments or cfg.has_encoder_context:
        raise NotImplementedError(f"{cfg.name}: encoder / frontend context "
                                  f"is not ported yet")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_attn(gen: torch.Generator, cfg: ModelConfig, r: int) -> dict:
    d, h, g, e = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pd, dev = _dtype(cfg.param_dtype), gen.device
    p = {
        "norm": torch.zeros((r, d), dtype=pd, device=dev),
        "wq": dense_init(gen, (r, d, h, e), d, pd),
        "wk": dense_init(gen, (r, d, g, e), d, pd),
        "wv": dense_init(gen, (r, d, g, e), d, pd),
        "wo": dense_init(gen, (r, h, e, d), h * e, pd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((r, h, e), dtype=pd, device=dev)
        p["bk"] = torch.zeros((r, g, e), dtype=pd, device=dev)
        p["bv"] = torch.zeros((r, g, e), dtype=pd, device=dev)
    return p


def _init_mlp(gen: torch.Generator, cfg: ModelConfig, r: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    pd = _dtype(cfg.param_dtype)
    return {
        "norm": torch.zeros((r, d), dtype=pd, device=gen.device),
        "w_gate": dense_init(gen, (r, d, f), d, pd),
        "w_up": dense_init(gen, (r, d, f), d, pd),
        "w_down": dense_init(gen, (r, f, d), f, pd),
    }


def _init_segment(gen: torch.Generator, seg: Segment,
                  cfg: ModelConfig) -> dict:
    return {f"pos{i}": {"mixer": _init_attn(gen, cfg, seg.repeats),
                        "ffn": _init_mlp(gen, cfg, seg.repeats)}
            for i, _ in enumerate(seg.pattern)}


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters drawn from ``gen``, on ``gen``'s device, in
    ``cfg.param_dtype``. Norms and QKV biases start at zero, as in the
    reference; the same seed gives other numbers than ``jax.random``
    (tests carry the reference's parameters across with
    ``convert.load_lm_params``)."""
    _check_ported(cfg)
    pd = _dtype(cfg.param_dtype)
    params = {
        "embed": dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                            cfg.d_model, pd),
        "final_norm": torch.zeros((cfg.d_model,), dtype=pd,
                                  device=gen.device),
        "segments": [_init_segment(gen, seg, cfg) for seg in cfg.segments],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                                       cfg.d_model, pd)
    return params


def _layer(tree: dict, r: int) -> dict:
    """Layer ``r``'s views of a stacked parameter (or cache) subtree."""
    return {k: _layer(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _apply_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["norm"])
    return (F.silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"]


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            enc_context: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            return_hidden: bool = False):
    """Full-sequence forward. tokens (B, S) integer ids. Returns ``(logits
    (B, S, padded_vocab), metrics)`` — or ``(hidden (B, S, D), metrics)``
    with ``return_hidden`` — where ``metrics`` is ``{"moe_aux": 0.0}`` as
    a float32 tensor (a dense stack has no MoE loss).

    Only the default positions ``arange(S)`` are supported: the flash
    kernel masks by index, so ``positions`` must be None; ``enc_context``
    too (no encoder or frontend context is ported)."""
    _check_ported(cfg)
    if enc_context is not None:
        raise NotImplementedError("enc_context: no encoder or frontend "
                                  "context is ported yet")
    if positions is not None:
        raise NotImplementedError("explicit positions: the flash kernel "
                                  "masks by index, so only arange(S) runs")
    b, s = tokens.shape
    x = params["embed"][tokens].to(_dtype(cfg.dtype))
    pos = torch.arange(s, device=x.device).expand(b, s)
    for seg, seg_params in zip(cfg.segments, params["segments"]):
        for r in range(seg.repeats):
            for i, _ in enumerate(seg.pattern):
                lp = _layer(seg_params[f"pos{i}"], r)
                mx = lp["mixer"]
                x = x + attn.self_attention(mx, rms_norm(x, mx["norm"]), pos,
                                            cfg=cfg)
                x = x + _apply_ffn(lp["ffn"], x)
    x = rms_norm(x, params["final_norm"])
    metrics = {"moe_aux": torch.zeros((), dtype=torch.float32,
                                      device=x.device)}
    if return_hidden:
        return x, metrics
    return head_logits(lm_head_weights(params, cfg), cfg, x), metrics


def lm_head_weights(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def head_logits(head: torch.Tensor, cfg: ModelConfig,
                x: torch.Tensor) -> torch.Tensor:
    """Vocab projection over the padded table; pad columns set to -1e30."""
    logits = x @ head.T
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


# ---------------------------------------------------------------------------
# Decode (serve_step body)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype: torch.dtype = torch.bfloat16, *, device="cuda",
               kv_quant: bool = False) -> dict:
    """Zeroed KV cache mirroring the segment structure: ``{"segments":
    [{"pos{i}": {"k", "v": (repeats, batch, seq_len, Kv, hd)}}]}``."""
    _check_ported(cfg)
    if kv_quant:
        raise NotImplementedError("the int8 KV cache is not ported yet")
    dev = resolve_device(device)
    shape = (batch, seq_len, cfg.num_kv_heads, cfg.head_dim)
    return {"segments": [
        {f"pos{i}": {"k": torch.zeros((seg.repeats, *shape), dtype=dtype,
                                      device=dev),
                     "v": torch.zeros((seg.repeats, *shape), dtype=dtype,
                                      device=dev)}
         for i, _ in enumerate(seg.pattern)}
        for seg in cfg.segments]}


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: torch.Tensor):
    """One decode step. tokens (B, 1) integer ids; pos (B,) positions of
    the new token, each in ``[0, seq_len)``. Returns ``(logits (B,
    padded_vocab), cache)``: the cache is updated IN PLACE and returned.

    A position past the cache raises (the reference drops the write): on
    the CPU at once, on the card as a device-side assert of the cache
    write or the decode kernel, raised at the next synchronisation — the
    step itself never reads back from the device."""
    _check_ported(cfg)
    x = params["embed"][tokens].to(_dtype(cfg.dtype))
    for seg, seg_params, seg_cache in zip(cfg.segments, params["segments"],
                                          cache["segments"]):
        for r in range(seg.repeats):
            for i, _ in enumerate(seg.pattern):
                lp = _layer(seg_params[f"pos{i}"], r)
                mx = lp["mixer"]
                dx, _ = attn.decode_self_attention(
                    mx, rms_norm(x, mx["norm"]), pos,
                    _layer(seg_cache[f"pos{i}"], r), cfg=cfg)
                x = x + dx
                x = x + _apply_ffn(lp["ffn"], x)
    x = rms_norm(x, params["final_norm"])
    logits = head_logits(lm_head_weights(params, cfg), cfg, x)[:, 0]
    return logits, cache
