"""LM composition: parameter init, full-sequence forward (prefill and
training) and single-token decode — the counterpart of the reference's
``models/model.py`` for stacks of global, sliding-window, bidirectional
encoder and cross attention and Mamba-2 mixers (``models.ssm``) with an
``MLP``, a ``MOE`` (``models.moe``) or no FFN, decoder-only or with an
encoder.

Parameters are a plain dict with the reference's nesting (``embed``,
``final_norm``, ``segments[i]["pos{j}"]["mixer" | "ffn"]``, ``lm_head``
when the head is untied, ``encoder = {"segments", "final_norm"}`` for
an encoder-decoder; a position whose FFN is ``NONE`` has no
``"ffn"``), each layer leaf stacked on a leading
``repeats`` axis. The reference scans that axis with ``jax.lax.scan``;
the port loops over it in Python. ``forward`` unbinds every stacked leaf
once (under autograd one ``UnbindBackward`` stacks the layers'
gradients, where a ``v[r]`` view per layer would build a gradient the
size of the whole stack for every layer) and, with ``cfg.remat`` and
grad enabled, recomputes each layer in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``). Tokens
are embedded through ``common.embed_tokens``: the ``embedding_lookup``
kernel forward, ``embedding_scatter_add`` backward.

A MoE layer returns its aux loss and expert counts beside its output (out
of the checkpointed block too, as tensors); ``forward`` returns them as
the reference's metrics. A Mamba layer's decode cache is its conv state
and its float32 SSM state, updated in place; a sliding-window layer's a
ring of ``min(window_size, seq_len)`` K/V rows; a cross layer's the
encoder's K/V over ``encoder_len`` frames, filled once by
``precompute_cross_cache`` and read-only during decode.

A model with context (``cfg.has_encoder_context``) takes stub frontend
embeddings ``enc_context`` (B, T, D): an encoder-decoder (whisper) runs
them through its encoder stack (``encode``), a model without an encoder
(llama-3.2-vision) attends to them as they are, cast to the activations'
dtype — the reference's two branches. With ``init_cache(kv_quant=True)``
the global and sliding-window positions cache int8 K/V rows with a
float32 scale each (``attention.decode_self_attention`` quantizes and
reads them).

Each layer's mixer (its norm included), a MoE layer's FFN (its norm,
routed and shared experts) and the head run inside spans of
``obs.trace``: ``layer.mixer`` (``kind`` attention, cross_attention or
ssm; under remat the recompute's too), ``layer.moe`` (in ``forward``
with ``held_rows`` and ``max_rows``, device scalars the tracer reads at
export) and ``model.head``, with device intervals in ``forward`` and
host-only in a decode step (two event records a span would cost a step
more than its shares are worth; its spans say what the host was doing).
They record only under a profiler or a tracer turned on.

The port's own architectures (``configs.PortModelConfig``) add muP-style
scalars: the embeddings times ``embedding_multiplier``, both residual
branches of a layer times ``residual_multiplier``, the logits divided by
``logits_scaling`` (``head_logits``, so training, prefill and decode
alike), every norm at ``norm_eps``; a MoE layer's shared expert under
``ffn["shared"]``. At the neutral values every other config has, none
adds an operation.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, CROSS_ATTN, ENC_ATTN, LOCAL_ATTN,
                                      MAMBA, MLP, MOE, NONE, LayerSpec,
                                      ModelConfig, Segment)
from repro_torch.core.ps import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm
from repro_torch.models.common import (constrain_batch, dense_init,
                                      embed_tokens, fsdp_gather, rms_norm)
from repro_torch.obs import trace as obs_trace

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the ``kind`` of a ``layer.mixer`` span, by the layer's mixer
_MIXER_KIND = {MAMBA: "ssm", CROSS_ATTN: "cross_attention"}


def _mixer_span(spec: LayerSpec, device: bool):
    """The span of a layer's mixer (its norm included); ``device``: with
    its device interval."""
    return obs_trace.get_tracer().span(
        "layer.mixer", device=device,
        kind=_MIXER_KIND.get(spec.mixer, "attention"))


def _dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r} is not one of {sorted(_DTYPES)}")
    return _DTYPES[name]


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


def _init_moe(gen: torch.Generator, cfg: ModelConfig, r: int) -> dict:
    """The router (over all ``num_experts``) in float32 whatever
    ``param_dtype``, as the reference draws it; the held experts; a
    shared expert where the configuration has one."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    held = cfg.held_experts
    pd = _dtype(cfg.param_dtype)
    p = {
        "norm": torch.zeros((r, d), dtype=pd, device=gen.device),
        "router": dense_init(gen, (r, d, e), d, torch.float32),
        "w_gate": dense_init(gen, (r, held, d, f), d, pd),
        "w_up": dense_init(gen, (r, held, d, f), d, pd),
        "w_down": dense_init(gen, (r, held, f, d), f, pd),
    }
    if cfg.shared_expert_ff:
        fs = cfg.shared_expert_ff
        p["shared"] = {"w_gate": dense_init(gen, (r, d, fs), d, pd),
                       "w_up": dense_init(gen, (r, d, fs), d, pd),
                       "w_down": dense_init(gen, (r, fs, d), fs, pd)}
    return p


def _init_mamba(gen: torch.Generator, cfg: ModelConfig, r: int) -> dict:
    """``A_log`` (A = -1), ``D`` and ``dt_bias`` in float32 whatever
    ``param_dtype``, as the reference draws them."""
    d, di, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_num_heads
    cw = cfg.ssm_conv_width
    pd, dev, f32 = _dtype(cfg.param_dtype), gen.device, torch.float32
    ch = di + 2 * ns
    return {
        "norm": torch.zeros((r, d), dtype=pd, device=dev),
        "wz": dense_init(gen, (r, d, di), d, pd),
        "wx": dense_init(gen, (r, d, di), d, pd),
        "wB": dense_init(gen, (r, d, ns), d, pd),
        "wC": dense_init(gen, (r, d, ns), d, pd),
        "wdt": dense_init(gen, (r, d, nh), d, pd),
        "conv_w": dense_init(gen, (r, cw, ch), cw, pd),
        "conv_b": torch.zeros((r, ch), dtype=pd, device=dev),
        "A_log": torch.zeros((r, nh), dtype=f32, device=dev),
        "D": torch.ones((r, nh), dtype=f32, device=dev),
        "dt_bias": torch.full((r, nh), math.log(math.e - 1), dtype=f32,
                              device=dev),
        "gnorm": torch.zeros((r, di), dtype=pd, device=dev),
        "out_proj": dense_init(gen, (r, di, d), di, pd),
    }


_MIXER_INIT = {ATTN: _init_attn, LOCAL_ATTN: _init_attn, ENC_ATTN: _init_attn,
               CROSS_ATTN: _init_attn, MAMBA: _init_mamba}
_FFN_INIT = {MLP: _init_mlp, MOE: _init_moe}


def _init_segment(gen: torch.Generator, seg: Segment,
                  cfg: ModelConfig) -> dict:
    out = {}
    for i, spec in enumerate(seg.pattern):
        p = {"mixer": _MIXER_INIT[spec.mixer](gen, cfg, seg.repeats)}
        if spec.ffn != NONE:
            p["ffn"] = _FFN_INIT[spec.ffn](gen, cfg, seg.repeats)
        out[f"pos{i}"] = p
    return out


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters drawn from ``gen``, on ``gen``'s device, in
    ``cfg.param_dtype`` (a Mamba layer's ``A_log``, ``D`` and ``dt_bias``
    and a MoE router in float32); an encoder-decoder's ``encoder``
    subtree drawn last. Norms and biases start at zero, as in the
    reference; the same seed gives other numbers than ``jax.random``
    (tests carry the reference's parameters across with
    ``convert.load_lm_params``)."""
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
    if cfg.encoder_segments:
        params["encoder"] = {
            "segments": [_init_segment(gen, seg, cfg)
                         for seg in cfg.encoder_segments],
            "final_norm": torch.zeros((cfg.d_model,), dtype=pd,
                                      device=gen.device)}
    return params


def _layer(tree: dict, r: int) -> dict:
    """Layer ``r``'s views of a stacked parameter (or cache) subtree."""
    return {k: _layer(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def _unbind(tree: dict, repeats: int) -> list[dict]:
    """Every layer's views of a stacked parameter subtree, each leaf
    unbound once: ``[_layer(tree, r) for r in range(repeats)]``, with one
    autograd node per leaf instead of one per layer."""
    per_key = {k: _unbind(v, repeats) if isinstance(v, dict)
               else torch.unbind(v, 0) for k, v in tree.items()}
    return [{k: v[r] for k, v in per_key.items()} for r in range(repeats)]


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _residual(dx: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A residual branch's output times ``cfg.residual_multiplier`` (no
    operation at 1)."""
    m = cfg.residual_multiplier
    return dx if m == 1.0 else dx * m


def _ffn_span(spec: LayerSpec, device: bool):
    """The span of a MoE layer's FFN (its norm included), ``layer.moe``;
    ``device``: with its device interval. An MLP's FFN has none."""
    if spec.ffn == MOE:
        return obs_trace.get_tracer().span("layer.moe", device=device)
    return contextlib.nullcontext()


def _apply_ffn(spec: LayerSpec, p: dict, x: torch.Tensor,
               cfg: ModelConfig):
    """Returns ``(out, aux_loss, expert_counts)``: the last two None for
    an MLP. Not called for a ``NONE`` FFN (the reference adds zeros)."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if spec.ffn == MOE:
        return moe_lib.moe_ffn(p, h, cfg)
    return (F.silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"], \
        None, None


def _block(spec: LayerSpec, lp: dict, x: torch.Tensor, pos: torch.Tensor,
           enc: Optional[torch.Tensor], cfg: ModelConfig):
    """One layer with its residuals: ``(x, aux_loss, expert_counts)`` as
    ``_apply_ffn`` gives them (None, None without an FFN). ``enc`` (B, T,
    D) is what a cross layer attends to."""
    lp = fsdp_gather(lp)
    mx = lp["mixer"]
    with _mixer_span(spec, device=True):
        h = rms_norm(x, mx["norm"], cfg.norm_eps)
        if spec.mixer == MAMBA:
            dx = ssm.mamba_block(mx, h, cfg)
        elif spec.mixer == CROSS_ATTN:
            dx = attn.cross_attention(mx, h, enc, cfg=cfg)
        else:
            window = cfg.window_size if spec.mixer == LOCAL_ATTN else 0
            dx = attn.self_attention(mx, h, pos, cfg=cfg,
                                     causal=spec.mixer != ENC_ATTN,
                                     window=window)
        x = x + _residual(dx, cfg)
    if spec.ffn == NONE:
        return x, None, None
    x = constrain_batch(x)
    with _ffn_span(spec, device=True) as sp:
        dx, aux, counts = _apply_ffn(spec, lp["ffn"], x, cfg)
        if counts is not None and sp.id:
            # device scalars, read when the tracer exports, never here
            sp.set(held_rows=counts.sum(), max_rows=counts.max())
    return x + _residual(dx, cfg), aux, counts


def _run_segments(x: torch.Tensor, segments_params: list,
                  segments: tuple[Segment, ...], cfg: ModelConfig,
                  pos: torch.Tensor, enc: Optional[torch.Tensor]):
    """Every layer of ``segments`` over x, each recomputed in the backward
    with ``cfg.remat`` and grad enabled. Returns ``(x, aux_total,
    per_layer)``: the MoE layers' float32 aux loss summed, and one
    ``{"pos{i}": (repeats, E) counts}`` dict a segment."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    per_layer = []                  # one {pos: [counts a repeat]} a segment
    for seg, seg_params in zip(segments, segments_params):
        layers = [_unbind(seg_params[f"pos{i}"], seg.repeats)
                  for i, _ in enumerate(seg.pattern)]
        seg_counts: dict = {}
        for r in range(seg.repeats):
            for i, (spec, per_pos) in enumerate(zip(seg.pattern, layers)):
                if remat:
                    x, aux, counts = checkpoint(_block, spec, per_pos[r], x,
                                                pos, enc, cfg,
                                                use_reentrant=False)
                else:
                    x, aux, counts = _block(spec, per_pos[r], x, pos, enc,
                                            cfg)
                x = constrain_batch(x)
                if counts is not None:
                    aux_total = aux_total + aux
                    seg_counts.setdefault(f"pos{i}", []).append(counts)
        per_layer.append({k: torch.stack(v) for k, v in seg_counts.items()})
    return x, aux_total, per_layer


def encode(params: dict, cfg: ModelConfig,
           enc_input: torch.Tensor) -> torch.Tensor:
    """The encoder stack over stub frontend embeddings ``enc_input`` (B,
    T, D), cast to ``cfg.dtype``, at positions ``arange(T)``; returns the
    final-normed states (B, T, D)."""
    x = constrain_batch(enc_input.to(_dtype(cfg.dtype)))
    b, t = x.shape[:2]
    pos = torch.arange(t, device=x.device).expand(b, t)
    x, _, _ = _run_segments(x, params["encoder"]["segments"],
                            cfg.encoder_segments, cfg, pos, None)
    return rms_norm(x, params["encoder"]["final_norm"])


def _context(params: dict, cfg: ModelConfig,
             enc_context: Optional[torch.Tensor],
             dtype: torch.dtype) -> Optional[torch.Tensor]:
    """What the cross layers attend to: ``encode(enc_context)`` for an
    encoder-decoder, ``enc_context`` in ``dtype`` for a model with
    context and no encoder, None for a decoder-only model. A context
    where the model takes none, or none where it takes one, raises
    ``ValueError``."""
    if not cfg.has_encoder_context:
        if enc_context is not None:
            raise ValueError(f"{cfg.name} takes no enc_context")
        return None
    if enc_context is None or enc_context.dim() != 3 \
            or enc_context.shape[-1] != cfg.d_model:
        got = None if enc_context is None else tuple(enc_context.shape)
        raise ValueError(f"{cfg.name} needs enc_context (B, T, "
                         f"{cfg.d_model}), got {got}")
    if cfg.is_encdec:
        return encode(params, cfg, enc_context)
    return enc_context.to(dtype)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            enc_context: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            return_hidden: bool = False):
    """Full-sequence forward. tokens (B, S) integer ids; ``enc_context``
    (B, T, D) stub frontend embeddings for a model with context (none
    otherwise). Returns ``(logits (B, S, padded_vocab), metrics)`` — or
    ``(hidden (B, S, D), metrics)`` with ``return_hidden``.
    ``metrics["moe_aux"]`` is the float32 sum of the MoE layers' aux
    losses (0 for a dense stack); a config with experts adds
    ``expert_counts`` (E,) int32, summed over the layers, and
    ``expert_counts_per_layer``: one ``{"pos{i}": (repeats, E) int32}``
    dict a segment, as the reference's scan stacks them.

    Only the default positions ``arange(S)`` are supported: the flash
    kernel masks by index, so ``positions`` must be None. A
    sliding-window layer takes ``attention.self_attention``'s branches
    by S and the window, and raises where the reference does."""
    if positions is not None:
        raise NotImplementedError("explicit positions: the flash kernel "
                                  "masks by index, so only arange(S) runs")
    b, s = tokens.shape
    x = constrain_batch(_embed(params, cfg, tokens))
    enc = _context(params, cfg, enc_context, x.dtype)
    pos = torch.arange(s, device=x.device).expand(b, s)
    x, aux_total, per_layer = _run_segments(x, params["segments"],
                                            cfg.segments, cfg, pos, enc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    metrics = {"moe_aux": aux_total}
    if cfg.num_experts:
        metrics["expert_counts"] = sum(
            c.sum(0, dtype=torch.int32) for seg in per_layer
            for c in seg.values())
        metrics["expert_counts_per_layer"] = per_layer
    if return_hidden:
        return x, metrics
    with obs_trace.get_tracer().span("model.head", device=True):
        return head_logits(lm_head_weights(params, cfg), cfg, x), metrics


def _embed(params: dict, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' embeddings in ``cfg.dtype``, times
    ``cfg.embedding_multiplier`` (no operation at 1)."""
    x = embed_tokens(params["embed"], tokens).to(_dtype(cfg.dtype))
    m = cfg.embedding_multiplier
    return x if m == 1.0 else x * m


def lm_head_weights(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def head_logits(head: torch.Tensor, cfg: ModelConfig,
                x: torch.Tensor) -> torch.Tensor:
    """Vocab projection over the padded table, divided by
    ``cfg.logits_scaling`` (no operation at 1); pad columns set to -1e30.
    Training, prefill and decode all take their logits here."""
    logits = x @ fsdp_gather(head).T
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    if cfg.padded_vocab != cfg.vocab_size:
        if type(logits) is torch.Tensor:
            logits[..., cfg.vocab_size:] = -1e30
        else:           # a DTensor: no rule for the in-place fill
            pad = torch.arange(cfg.padded_vocab,
                               device=logits.device) >= cfg.vocab_size
            logits = logits.masked_fill(pad, -1e30)
    return logits


# ---------------------------------------------------------------------------
# Decode (serve_step body)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype: torch.dtype = torch.bfloat16, *, device="cuda",
               kv_quant: bool = False, abstract: bool = False) -> dict:
    """Zeroed cache mirroring the segment structure: ``{"segments":
    [{"pos{i}": entry}]}``, an attention position's entry ``{"k", "v":
    (repeats, batch, seq_len, Kv, hd)}`` in ``dtype`` (a sliding-window
    position's a ring of ``min(window_size, seq_len)`` rows), a cross
    position's ``{"xk", "xv": (repeats, batch, encoder_len, Kv, hd)}``
    in ``dtype`` (``precompute_cross_cache`` fills it), a Mamba
    position's ``{"conv": (repeats, batch, K - 1, d_inner + 2 N)}`` in
    ``dtype`` and ``{"state": (repeats, batch, H, P, N)}`` in float32.
    ``kv_quant`` makes an attention position's ``k`` and ``v`` int8 and
    adds float32 ``k_scale`` and ``v_scale`` of shape ``(..., Kv, 1)``,
    one absmax scale a (token, head) row, as the reference's; cross and
    Mamba entries stay as they are. ``abstract`` gives the same tree of
    ``meta`` tensors (shapes and dtypes, no data; ``device`` unused), as
    the reference's gives ``ShapeDtypeStruct``s."""
    dev = torch.device("meta") if abstract else resolve_device(device)

    def zeros(*shape, dt=dtype):
        if abstract:
            return torch.empty(shape, dtype=dt, device=dev)
        return torch.zeros(shape, dtype=dt, device=dev)

    def entry(spec: LayerSpec, r: int) -> dict:
        if spec.mixer == MAMBA:
            return {"conv": zeros(r, batch, cfg.ssm_conv_width - 1,
                                  cfg.d_inner + 2 * cfg.ssm_state),
                    "state": zeros(r, batch, cfg.ssm_num_heads,
                                   cfg.ssm_head_dim, cfg.ssm_state,
                                   dt=torch.float32)}
        kv = (cfg.num_kv_heads, cfg.head_dim)
        if spec.mixer == CROSS_ATTN:
            shape = (r, batch, cfg.encoder_len, *kv)
            return {"xk": zeros(*shape), "xv": zeros(*shape)}
        rows = min(cfg.window_size, seq_len) if spec.mixer == LOCAL_ATTN \
            else seq_len
        shape = (r, batch, rows, *kv)
        if not kv_quant:
            return {"k": zeros(*shape), "v": zeros(*shape)}
        return {"k": zeros(*shape, dt=torch.int8),
                "v": zeros(*shape, dt=torch.int8),
                "k_scale": zeros(*shape[:-1], 1, dt=torch.float32),
                "v_scale": zeros(*shape[:-1], 1, dt=torch.float32)}

    return {"segments": [
        {f"pos{i}": entry(spec, seg.repeats)
         for i, spec in enumerate(seg.pattern)}
        for seg in cfg.segments]}


def precompute_cross_cache(params: dict, cfg: ModelConfig, cache: dict,
                           enc_context: torch.Tensor) -> dict:
    """Fill every cross position's ``xk``, ``xv`` of ``cache`` IN PLACE
    from ``enc_context`` (B, encoder_len, D): the encoder's states (or,
    without an encoder, the context in ``cfg.dtype``) through each
    layer's K and V projections and biases, cast to the cache's dtype.
    Returns ``cache``. Runs without autograd: the cache is a serving
    buffer."""
    with torch.no_grad():
        enc = _context(params, cfg, enc_context, _dtype(cfg.dtype))
        for seg, seg_params, seg_cache in zip(cfg.segments,
                                              params["segments"],
                                              cache["segments"]):
            for i, spec in enumerate(seg.pattern):
                if spec.mixer != CROSS_ATTN:
                    continue
                entry = seg_cache[f"pos{i}"]
                for r, lp in enumerate(_unbind(seg_params[f"pos{i}"]
                                               ["mixer"], seg.repeats)):
                    k, v = attn.project_kv(lp, enc)
                    entry["xk"][r].copy_(k)
                    entry["xv"][r].copy_(v)
    return cache


def decode_layer(spec: LayerSpec, lp: dict, lc: dict, x: torch.Tensor,
                 pos: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One layer of a decode step with its residuals: x (B, 1, D) through
    the mixer against the layer's cache entry ``lc`` (updated IN PLACE)
    and the FFN. Returns the new x."""
    lp = fsdp_gather(lp)
    mx = lp["mixer"]
    with _mixer_span(spec, device=False):
        h = rms_norm(x, mx["norm"], cfg.norm_eps)
        if spec.mixer == MAMBA:
            dx, conv, state = ssm.mamba_decode_step(mx, h, lc["conv"],
                                                    lc["state"], cfg)
            lc["conv"].copy_(conv)
            lc["state"].copy_(state)
        elif spec.mixer == CROSS_ATTN:
            dx = attn.decode_cross_attention(mx, h, lc["xk"], lc["xv"],
                                             cfg=cfg)
        else:
            window = min(cfg.window_size, lc["k"].shape[1]) \
                if spec.mixer == LOCAL_ATTN else 0
            dx, _ = attn.decode_self_attention(mx, h, pos, lc, cfg=cfg,
                                               window=window)
    x = constrain_batch(x + _residual(dx, cfg))
    if spec.ffn != NONE:
        with _ffn_span(spec, device=False):
            dx = _apply_ffn(spec, lp["ffn"], x, cfg)[0]
        x = constrain_batch(x + _residual(dx, cfg))
    return x


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: torch.Tensor):
    """One decode step. tokens (B, 1) integer ids; pos (B,) positions of
    the new token, each in ``[0, seq_len)``. Returns ``(logits (B,
    padded_vocab), cache)``: the cache is updated IN PLACE and returned.
    A MoE layer runs ``moe_ffn`` over the B new tokens with
    ``moe_capacity(B)`` slots an expert (at least 8, as in the
    reference), so a batch of up to 8 drops nothing; its aux loss and
    counts are not returned.

    A Mamba layer ignores ``pos``: its conv and SSM states are overwritten
    with the step's new ones. A sliding-window layer writes its ring at
    ``pos % rows``, its window clamped to the ring's rows as the
    reference's ``_decode_mixer`` clamps it, so a ring never runs out.

    A position past a global layer's cache raises (the reference drops
    the write): on the CPU at once, on the card as a device-side assert
    of the cache write or the decode kernel, raised at the next
    synchronisation — the step itself never reads back from the
    device. A cross layer attends its ``xk``, ``xv`` entry over every
    frame and leaves it as it is."""
    x = constrain_batch(_embed(params, cfg, tokens))
    for seg, seg_params, seg_cache in zip(cfg.segments, params["segments"],
                                          cache["segments"]):
        for r in range(seg.repeats):
            for i, spec in enumerate(seg.pattern):
                x = decode_layer(spec, _layer(seg_params[f"pos{i}"], r),
                                 _layer(seg_cache[f"pos{i}"], r), x, pos,
                                 cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    with obs_trace.get_tracer().span("model.head"):
        logits = head_logits(lm_head_weights(params, cfg), cfg, x)[:, 0]
    return logits, cache
