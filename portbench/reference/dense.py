"""Plain reference of a dense decoder with grouped-query attention
(qwen2): float32 (TF32 off) or the control's fp8, no kernels, no cache
beyond a list of rows, no batching tricks.

Per layer: ``x + o(attn(rope(q), rope(k), v))`` on ``rms_norm(x)``, q, k
and v with their biases, then ``x + down(silu(gate(h)) * up(h))`` on
``rms_norm(x)``; a final norm and the tied head over the vocabulary.
It reads the benchmark's weights in the port's layout and computes the
rest itself. Also the model's operation counts for the per-layer
readers (``train_flops``, ``forward_flops``, ``decode_flops``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.common import (STACK, act, mm, nll_sum,
                                        padded_vocab, rms_norm, rope,
                                        shared_leaves, single_segment)

QUERY_BLOCK = 1024


def leaf_specs(spec: dict) -> dict:
    """``{path: (shape, init, arg, float32)}`` of every parameter in the
    port's layout (``weights.make_leaf``): per layer the attention's
    norm, q, k, v and o with the q, k and v biases where the file has
    ``qkv_bias``, and the gated MLP's norm, gate, up and down."""
    d, layers = spec["hidden_size"], spec["num_hidden_layers"]
    h, g = spec["num_attention_heads"], spec["num_key_value_heads"]
    e, f = spec["head_dim"], spec["intermediate_size"]
    mx, ff = f"{STACK}/mixer", f"{STACK}/ffn"
    out = shared_leaves(spec)
    out.update({
        f"{mx}/norm": ((layers, d), "normal", 0.1, False),
        f"{mx}/wq": ((layers, d, h, e), "normal", d ** -0.5, False),
        f"{mx}/wk": ((layers, d, g, e), "normal", d ** -0.5, False),
        f"{mx}/wv": ((layers, d, g, e), "normal", d ** -0.5, False),
        f"{mx}/wo": ((layers, h, e, d), "normal", (h * e) ** -0.5, False),
        f"{ff}/norm": ((layers, d), "normal", 0.1, False),
        f"{ff}/w_gate": ((layers, d, f), "normal", d ** -0.5, False),
        f"{ff}/w_up": ((layers, d, f), "normal", d ** -0.5, False),
        f"{ff}/w_down": ((layers, f, d), "normal", f ** -0.5, False)})
    if spec["qkv_bias"]:
        out.update({
            f"{mx}/bq": ((layers, h, e), "normal", 0.1, False),
            f"{mx}/bk": ((layers, g, e), "normal", 0.1, False),
            f"{mx}/bv": ((layers, g, e), "normal", 0.1, False)})
    return out


def port_segments(spec: dict, base):
    """The port's segments: the registered pattern, one layer a repeat."""
    return single_segment(spec, base)


def matmul_params(spec: dict) -> int:
    """Parameters each token multiplies: q, k, v, o, the MLP's three and
    the head over the padded table."""
    d, h, g, e = (spec["hidden_size"], spec["num_attention_heads"],
                  spec["num_key_value_heads"], spec["head_dim"])
    per_layer = 2 * d * h * e + 2 * d * g * e + 3 * d * spec["intermediate_size"]
    return spec["num_hidden_layers"] * per_layer + padded_vocab(spec) * d


def forward_flops(spec: dict, batch: int, seq: int) -> float:
    """Model FLOPs of a forward over (batch, seq): 2 a matmul parameter a
    token, plus causal attention's two products, 2 * B * H * S^2 * hd a
    layer."""
    attn = 2.0 * batch * spec["num_attention_heads"] * seq * seq \
        * spec["head_dim"] * spec["num_hidden_layers"]
    return 2.0 * batch * seq * matmul_params(spec) + attn


def train_flops(spec: dict, batch: int, seq: int) -> float:
    """A train step: three times the forward (remat's recompute not
    counted)."""
    return 3.0 * forward_flops(spec, batch, seq)


def decode_flops(spec: dict, lengths) -> float:
    """One decode step of ``len(lengths)`` sequences, each attending
    ``lengths[b]`` rows: 2 a matmul parameter a token and 4 * H * hd a
    row a layer."""
    rows = float(sum(int(n) for n in lengths))
    return 2.0 * len(lengths) * matmul_params(spec) + 4.0 * rows \
        * spec["num_attention_heads"] * spec["head_dim"] \
        * spec["num_hidden_layers"]


def flash_flops_bytes(batch: int, heads: int, kv_heads: int, seq: int,
                      hd: int, elem_bytes: int = 2) -> tuple[float, float]:
    """What one causal attention call over (batch, seq) needs: FLOPs of
    the kept pairs with the diagonal, and q, k, v, o read or written
    once."""
    flops = 4.0 * batch * heads * hd * seq * (seq + 1) / 2
    nbytes = float(batch * seq * (2 * heads + 2 * kv_heads) * hd
                   * elem_bytes)
    return flops, nbytes


def decode_attention_bytes(lengths, heads: int, kv_heads: int, hd: int,
                           cache_bytes: int, q_bytes: int,
                           out_bytes: int) -> float:
    """What one decode attention call needs: each sequence's K and V rows
    below its length, q and the output."""
    rows = float(sum(int(n) for n in lengths))
    b = len(lengths)
    return rows * 2 * kv_heads * hd * cache_bytes \
        + b * heads * hd * (q_bytes + out_bytes)


def layer(params: dict, i: int) -> dict:
    """Layer ``i``'s mixer and ffn weights."""
    pos0 = params["segments"][0]["pos0"]
    return {part: {k: v[i] for k, v in pos0[part].items()}
            for part in ("mixer", "ffn")}


def attention(q, k, v, qpos, kpos) -> torch.Tensor:
    """Causal GQA attention by positions: q (B, S, H, hd), k, v (B, T, G,
    hd), a key kept where its position is at most the query's; float32
    softmax; in blocks of queries. Returns (B, S, H, hd)."""
    h, g = q.shape[2], k.shape[2]
    k = k.repeat_interleave(h // g, dim=2)
    v = v.repeat_interleave(h // g, dim=2)
    scale = q.shape[-1] ** -0.5
    outs = []
    for s0 in range(0, q.shape[1], QUERY_BLOCK):
        qb = q[:, s0:s0 + QUERY_BLOCK]
        sc = torch.einsum("bshd,bthd->bhst", qb, k) * scale
        keep = kpos[None, :] <= qpos[s0:s0 + QUERY_BLOCK, None]
        sc = sc.masked_fill(~keep, float("-inf"))
        outs.append(torch.einsum("bhst,bthd->bshd", torch.softmax(sc, -1), v))
    return torch.cat(outs, dim=1)


def qkv(lp: dict, h: torch.Tensor, spec: dict, prec: str):
    """q, k, v (B, S, heads, hd) of the normed input, with their biases."""
    b, s, d = h.shape
    out = []
    for w, bias in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
        y = mm(h, lp[w].reshape(d, -1), prec).view(b, s, *lp[w].shape[1:])
        if bias in lp:
            y = y + lp[bias]
        out.append(y)
    return out


def block(lp: dict, x, qpos, spec: dict, prec: str, past=None):
    """One layer over x (B, S, D) at positions ``qpos`` (S,). ``past``:
    (k, v) rows (B, T0, G, hd) before them, at positions 0..T0-1.
    Returns ``(x, k_rows, v_rows)``, the rows of all T0 + S positions."""
    eps, theta = spec["rms_norm_eps"], spec["rope_theta"]
    mx, ff = lp["mixer"], lp["ffn"]
    b, s, d = x.shape
    q, k, v = qkv(mx, rms_norm(x, mx["norm"], eps), spec, prec)
    q, k = rope(q, qpos, theta), rope(k, qpos, theta)
    if past is not None:
        k, v = torch.cat([past[0], k], 1), torch.cat([past[1], v], 1)
    kpos = torch.arange(k.shape[1], device=x.device)
    o = attention(q, k, v, qpos, kpos)
    x = x + mm(o.reshape(b, s, -1), mx["wo"].reshape(-1, d), prec)
    hh = rms_norm(x, ff["norm"], spec["rms_norm_eps"])
    gated = F.silu(mm(hh, ff["w_gate"], prec)) * mm(hh, ff["w_up"], prec)
    return act(x + mm(gated, ff["w_down"], prec), prec), k, v


def hidden(params: dict, spec: dict, tokens: torch.Tensor, prec: str,
           remat: bool = False) -> torch.Tensor:
    """Final-normed hidden states (B, S, D) of ``tokens`` (B, S) at
    positions 0..S-1."""
    x = act(params["embed"][tokens], prec)
    qpos = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(spec["num_hidden_layers"]):
        lp = layer(params, i)
        if remat:
            x = checkpoint(lambda lp_, x_: block(lp_, x_, qpos, spec,
                                                 prec)[0],
                           lp, x, use_reentrant=False)
        else:
            x = block(lp, x, qpos, spec, prec)[0]
    return rms_norm(x, params["final_norm"], spec["rms_norm_eps"])


def head(params: dict, spec: dict, x: torch.Tensor, prec: str):
    """Logits over the vocabulary (the tied table's first rows)."""
    return mm(x, params["embed"][:spec["vocab_size"]].T, prec)


def loss_and_grads(params: dict, spec: dict, tokens: torch.Tensor,
                   prec: str = "float32"):
    """Mean next-token NLL of ``tokens`` (B, S) and its gradient for every
    leaf of ``params`` (float32 leaves), a row at a time with each layer
    recomputed in the backward. Returns ``(loss, {path: grad})``."""
    from portbench.reference.tree import paths
    leaves = dict(paths(params))
    for t in leaves.values():
        t.requires_grad_(True)
        t.grad = None
    count = tokens.shape[0] * (tokens.shape[1] - 1)
    total = 0.0
    for r in range(tokens.shape[0]):
        row = tokens[r:r + 1]
        x = hidden(params, spec, row[:, :-1], prec, remat=True)
        loss = nll_sum(head(params, spec, x, prec), row[:, 1:]) / count
        loss.backward()
        total += float(loss.detach())
    grads = {p: t.grad for p, t in leaves.items()}
    for t in leaves.values():
        t.requires_grad_(False)
        t.grad = None
    return total, grads


@torch.no_grad()
def decode_logits(weight_sets: list, spec: dict, prefix: list,
                  tokens: torch.Tensor, start: int, swap_every: int,
                  prec: str = "float32") -> torch.Tensor:
    """Logits of a decoded sequence: ``tokens`` (n,) fed at positions
    ``start``..``start + n - 1``, after ``prefix`` (one ``(k, v)`` pair
    of (start, G, hd) rows a layer, positions 0..start-1). Step t of the
    stream runs ``weight_sets[(t // swap_every) % 2]``, and each layer's
    new rows come from the weights of their own step. Returns (n, V)."""
    past = [(k[None], v[None]) for k, v in prefix]
    out = []
    for t0 in range(0, tokens.shape[0], swap_every):
        params = weight_sets[(t0 // swap_every) % len(weight_sets)]
        toks = tokens[t0:t0 + swap_every]
        qpos = start + torch.arange(t0, t0 + toks.shape[0],
                                    device=tokens.device)
        x = act(params["embed"][toks][None], prec)
        for i in range(spec["num_hidden_layers"]):
            x, k, v = block(layer(params, i), x, qpos, spec, prec, past[i])
            past[i] = (k, v)
        x = rms_norm(x, params["final_norm"], spec["rms_norm_eps"])
        out.append(head(params, spec, x[0], prec))
    return torch.cat(out)
