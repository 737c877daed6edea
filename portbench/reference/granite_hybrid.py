"""Plain reference of a Granite 4.0-H stack (granite_hybrid): Mamba-2 and
NoPE attention layers, each followed by a dropless MoE beside a shared
expert, with muP-style scalars; float32 (TF32 off) or the control's fp8,
no kernels.

The equations are HF's ``GraniteMoeHybridDecoderLayer`` (model_type
granitemoehybrid), with ``m_r`` the ``residual_multiplier``:

    h = x + m_r * mixer(norm1(x))
    y = h + m_r * (moe(norm2(h)) + shared(norm2(h)))

- the embeddings times ``embedding_multiplier``; the logits over the
  tied table divided by ``logits_scaling``; every RMSNorm at
  ``rms_norm_eps``;
- the Mamba-2 mixer as ``reference/mamba2.py``'s (z, x, B, C and dt
  projections without bias, a causal depthwise conv with bias and SiLU,
  the SSD scan of the paper's minimal listing, ``y + D x``, a gated
  RMSNorm over all of d_inner (one group), the out projection);
- attention: q, k and v without bias, no positional embedding, a
  softmax scale of ``attention_multiplier``, grouped query heads;
- the MoE: router logits over all ``published_num_local_experts`` in
  float32, the softmax over the top k logits as gates, each expert
  ``down(silu(gate(x)) * up(x))``; the shared expert the same at its own
  width.

Departures, each the port's and named in the configuration's
``assumed``: the norm gain is ``(1 + scale)``; the loss adds the Switch
load-balance loss of every MoE layer (over the batch's tokens, top-1
counts against mean router probabilities, times the number of experts)
at weight 0.01, as the port's trainer does; the layer holds experts
``[0, num_local_experts)`` of the router's and leaves out what the
others would add (one card's share under expert parallelism).

Also the model's operation counts for the per-layer readers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.common import (act, mm, nll_sum, padded_vocab,
                                        rms_norm, shared_leaves)
from portbench.reference.mamba2 import ssd

QUERY_BLOCK = 1024
PERIOD = 10            # the published layer pattern's period
AUX_WEIGHT = 0.01      # the port's trainer's weight on the aux loss
PORT_MIXER = {"mamba": "mamba", "attention": "attn"}


def _dims(spec: dict) -> dict:
    d = spec["hidden_size"]
    di = spec["mamba_expand"] * d
    return {"d": d, "di": di, "n": spec["mamba_d_state"],
            "hp": spec["mamba_d_head"], "nh": di // spec["mamba_d_head"],
            "h": spec["num_attention_heads"],
            "g": spec["num_key_value_heads"],
            "e": d // spec["num_attention_heads"],
            "f": spec["intermediate_size"],
            "fs": spec["shared_intermediate_size"],
            "experts": spec["published_num_local_experts"],
            "held": spec["num_local_experts"],
            "k": spec["num_experts_per_tok"]}


def kinds(spec: dict) -> list:
    """The mixer of each layer of the stack: ``layer_types``' first
    ``num_hidden_layers``."""
    return spec["layer_types"][:spec["num_hidden_layers"]]


def leaf_specs(spec: dict) -> dict:
    """``{path: (shape, init, arg, float32)}`` of every parameter in the
    port's layout (``weights.make_leaf``): one segment of the period's
    ten positions, each leaf stacked over the period's repeats. A Mamba-2
    position's mixer as ``reference/mamba2.py`` lays it out; an
    attention position's norm, q, k, v and o; every position's MoE: its
    norm, the router (float32, as the port keeps it) over all the
    published experts, the held experts' gate, up and down, and the
    shared expert's."""
    z = _dims(spec)
    d, di, n, nh = z["d"], z["di"], z["n"], z["nh"]
    r = spec["num_hidden_layers"] // PERIOD
    k = spec["mamba_d_conv"]
    out = shared_leaves(spec)
    for i, kind in enumerate(kinds(spec)[:PERIOD]):
        mx, ff = f"segments/0/pos{i}/mixer", f"segments/0/pos{i}/ffn"
        if kind == "mamba":
            ch = di + 2 * n
            out.update({
                f"{mx}/norm": ((r, d), "normal", 0.1, False),
                f"{mx}/wz": ((r, d, di), "normal", d ** -0.5, False),
                f"{mx}/wx": ((r, d, di), "normal", d ** -0.5, False),
                f"{mx}/wB": ((r, d, n), "normal", d ** -0.5, False),
                f"{mx}/wC": ((r, d, n), "normal", d ** -0.5, False),
                f"{mx}/wdt": ((r, d, nh), "normal", d ** -0.5, False),
                f"{mx}/conv_w": ((r, k, ch), "normal", k ** -0.5, False),
                f"{mx}/conv_b": ((r, ch), "normal", 0.1, False),
                f"{mx}/A_log": ((r, nh), "uniform_log", (1.0, 16.0), True),
                f"{mx}/D": ((r, nh), "ones", None, True),
                f"{mx}/dt_bias": ((r, nh), "dt_bias", (1e-3, 1e-1), True),
                f"{mx}/gnorm": ((r, di), "normal", 0.1, False),
                f"{mx}/out_proj": ((r, di, d), "normal", di ** -0.5,
                                   False)})
        else:
            h, g, e = z["h"], z["g"], z["e"]
            out.update({
                f"{mx}/norm": ((r, d), "normal", 0.1, False),
                f"{mx}/wq": ((r, d, h, e), "normal", d ** -0.5, False),
                f"{mx}/wk": ((r, d, g, e), "normal", d ** -0.5, False),
                f"{mx}/wv": ((r, d, g, e), "normal", d ** -0.5, False),
                f"{mx}/wo": ((r, h, e, d), "normal", (h * e) ** -0.5,
                             False)})
        f, fs, held = z["f"], z["fs"], z["held"]
        out.update({
            f"{ff}/norm": ((r, d), "normal", 0.1, False),
            f"{ff}/router": ((r, d, z["experts"]), "normal", d ** -0.5,
                             True),
            f"{ff}/w_gate": ((r, held, d, f), "normal", d ** -0.5, False),
            f"{ff}/w_up": ((r, held, d, f), "normal", d ** -0.5, False),
            f"{ff}/w_down": ((r, held, f, d), "normal", f ** -0.5, False),
            f"{ff}/shared/w_gate": ((r, d, fs), "normal", d ** -0.5, False),
            f"{ff}/shared/w_up": ((r, d, fs), "normal", d ** -0.5, False),
            f"{ff}/shared/w_down": ((r, fs, d), "normal", fs ** -0.5,
                                    False)})
    return out


def port_segments(spec: dict, base):
    """The port's segments: the registered period, once per ``PERIOD``
    layers. The period's mixers must be the file's ``layer_types``."""
    import dataclasses
    seg = base.segments[0]
    want = [PORT_MIXER[k] for k in kinds(spec)[:PERIOD]]
    if len(base.segments) != 1 or [s.mixer for s in seg.pattern] != want \
            or spec["num_hidden_layers"] % PERIOD:
        raise ValueError(f"{spec['port_arch']}: the stack must be whole "
                         f"periods of the registered pattern")
    return (dataclasses.replace(seg, repeats=spec["num_hidden_layers"]
                                // PERIOD),)


# -- operation counts ------------------------------------------------------


def matmul_params(spec: dict) -> float:
    """Parameters each token multiplies: each Mamba-2 layer's in and out
    projections, each attention layer's q, k, v and o, each MoE layer's
    router, its held experts at their expected share ``k * held /
    experts`` of a token's routes, and its shared expert; and the head
    over the padded table."""
    z = _dims(spec)
    d, di, n, nh = z["d"], z["di"], z["n"], z["nh"]
    mamba = d * (2 * di + 2 * n + nh) + di * d
    attn = 2 * d * z["h"] * z["e"] + 2 * d * z["g"] * z["e"]
    moe = d * z["experts"] + z["k"] * z["held"] / z["experts"] \
        * 3 * d * z["f"] + 3 * d * z["fs"]
    per_kind = {"mamba": mamba, "attention": attn}
    return sum(per_kind[k] + moe for k in kinds(spec)) \
        + padded_vocab(spec) * d


def _ssd_flops(spec: dict, batch: int, seq: int) -> float:
    """The SSD's products of a forward, over each chunk's whole (l, l)
    square, as ``reference/mamba2.py`` counts them."""
    z = _dims(spec)
    n, nh, hp = z["n"], z["nh"], z["hp"]
    l = spec["mamba_chunk_size"]
    per_chunk = 2.0 * l * l * n + 2.0 * nh * l * l * hp \
        + 4.0 * nh * l * hp * n
    return batch * -(-seq // l) * per_chunk * kinds(spec).count("mamba")


def forward_flops(spec: dict, batch: int, seq: int) -> float:
    """2 a matmul parameter a token, the SSD's products, and causal
    attention's two products (2 * B * H * S^2 * hd an attention layer)."""
    z = _dims(spec)
    attn = 2.0 * batch * z["h"] * seq * seq * z["e"] \
        * kinds(spec).count("attention")
    return 2.0 * batch * seq * matmul_params(spec) \
        + _ssd_flops(spec, batch, seq) + attn


def train_flops(spec: dict, batch: int, seq: int) -> float:
    """A train step: three times the forward (remat's recompute not
    counted)."""
    return 3.0 * forward_flops(spec, batch, seq)


def expert_gemm_flops_bytes(rows: float, spec: dict,
                            backward: bool = False) -> tuple[float, float]:
    """What a MoE layer's grouped expert products need for ``rows``
    assignments routed to the held experts: the forward's gate, up and
    down products (``backward``: their input and weight gradients, twice
    the operations), each operand read once and each output written
    once: the rows, the held experts' weights, the products."""
    z = _dims(spec)
    d, f, held = z["d"], z["f"], z["held"]
    el = 2 if spec["torch_dtype"] == "bfloat16" else 4
    shapes = ((d, f), (d, f), (f, d))            # (K, N) of each product
    flops = sum(2.0 * rows * kk * nn for kk, nn in shapes)
    if not backward:
        return flops, sum(el * (rows * kk + held * kk * nn + rows * nn)
                          for kk, nn in shapes)
    # input gradient: dY, W read, dX written; weight gradient: X, dY read,
    # dW written
    return 2.0 * flops, sum(el * 2 * (rows * kk + held * kk * nn
                                      + rows * nn) for kk, nn in shapes)


# -- the model -------------------------------------------------------------


def layer(params: dict, i: int) -> dict:
    """Layer ``i``'s weights: position ``i % PERIOD`` of repeat ``i //
    PERIOD``."""
    pos = params["segments"][0][f"pos{i % PERIOD}"]

    def pick(node):
        return {k: pick(v) if isinstance(v, dict) else v[i // PERIOD]
                for k, v in node.items()}
    return pick(pos)


def mamba_mixer(lp: dict, h: torch.Tensor, spec: dict, prec: str):
    """The Mamba-2 mixer over the normed h (B, S, D)."""
    z = _dims(spec)
    di, n, nh, hp = z["di"], z["n"], z["nh"], z["hp"]
    b, s, _ = h.shape
    zz = mm(h, lp["wz"], prec)
    u = torch.cat([mm(h, lp["wx"], prec), mm(h, lp["wB"], prec),
                   mm(h, lp["wC"], prec)], dim=-1)
    k = lp["conv_w"].shape[0]
    up = F.pad(u, (0, 0, k - 1, 0))
    u = F.silu(sum(up[:, i:i + s] * lp["conv_w"][i] for i in range(k))
               + lp["conv_b"])
    xin, bb, cc = u[..., :di], u[..., di:di + n], u[..., di + n:]
    dt = F.softplus(mm(h, lp["wdt"], prec) + lp["dt_bias"], threshold=1e9)
    a = -torch.exp(lp["A_log"])
    xh = xin.reshape(b, s, nh, hp)
    chunk = spec["mamba_chunk_size"]
    pad = (-s) % chunk
    y = ssd(F.pad(xh * dt[..., None], (0, 0, 0, 0, 0, pad)),
            F.pad(dt * a, (0, 0, 0, pad)), F.pad(bb, (0, 0, 0, pad)),
            F.pad(cc, (0, 0, 0, pad)), chunk)[:, :s]
    y = y + lp["D"][:, None] * xh
    y = rms_norm(y.reshape(b, s, di) * F.silu(zz), lp["gnorm"],
                 spec["rms_norm_eps"])
    return mm(y, lp["out_proj"], prec)


def attention_mixer(lp: dict, h: torch.Tensor, spec: dict, prec: str):
    """Causal GQA attention over the normed h (B, S, D), no positional
    embedding, scores scaled by ``attention_multiplier``; float32 softmax,
    in blocks of queries."""
    b, s, d = h.shape
    q, k, v = (mm(h, lp[w].reshape(d, -1), prec).view(b, s, *lp[w].shape[1:])
               for w in ("wq", "wk", "wv"))
    rep = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    pos = torch.arange(s, device=h.device)
    outs = []
    for s0 in range(0, s, QUERY_BLOCK):
        sc = torch.einsum("bshd,bthd->bhst", q[:, s0:s0 + QUERY_BLOCK], k) \
            * spec["attention_multiplier"]
        keep = pos[None, :] <= pos[s0:s0 + QUERY_BLOCK, None]
        sc = sc.masked_fill(~keep, float("-inf"))
        outs.append(torch.einsum("bhst,bthd->bshd", torch.softmax(sc, -1),
                                 v))
    o = torch.cat(outs, dim=1).reshape(b, s, -1)
    return mm(o, lp["wo"].reshape(-1, d), prec)


def route(router: torch.Tensor, h: torch.Tensor, k: int):
    """(top-k expert ids, their gates: the softmax over the top-k logits,
    the router's probabilities) for the tokens h (T, D), in float32."""
    probs = torch.softmax(h @ router, dim=-1)
    top, idx = torch.topk(probs, k, dim=-1)
    return idx, top / top.sum(-1, keepdim=True), probs


def gated(x, wg, wu, wd, prec: str):
    return mm(F.silu(mm(x, wg, prec)) * mm(x, wu, prec), wd, prec)


def moe(lp: dict, h: torch.Tensor, spec: dict, prec: str):
    """The MoE with its shared expert over the normed h (B, S, D):
    ``(out, router probabilities summed over the tokens, top-1 counts)``,
    the last two for the batch's aux loss. Only the held experts
    compute."""
    z = _dims(spec)
    b, s, d = h.shape
    ht = h.reshape(-1, d)
    idx, gate, probs = route(lp["router"], ht, z["k"])
    out = torch.zeros_like(ht)
    for e in range(z["held"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            y = gated(ht[tok], lp["w_gate"][e], lp["w_up"][e],
                      lp["w_down"][e], prec)
            out = out.index_add(0, tok, y * gate[tok, slot, None])
    sh = lp["shared"]
    out = out + gated(ht, sh["w_gate"], sh["w_up"], sh["w_down"], prec)
    top1 = F.one_hot(idx[:, 0], z["experts"]).sum(0).float()
    return out.reshape(b, s, d), probs.sum(0), top1


def block(lp: dict, x: torch.Tensor, kind: str, spec: dict, prec: str):
    """One layer with its residuals over x (B, S, D): ``(x, router
    probabilities summed, top-1 counts)``."""
    eps, m_r = spec["rms_norm_eps"], spec["residual_multiplier"]
    mixer = mamba_mixer if kind == "mamba" else attention_mixer
    x = x + m_r * mixer(lp["mixer"], rms_norm(x, lp["mixer"]["norm"], eps),
                        spec, prec)
    y, psum, top1 = moe(lp["ffn"], rms_norm(x, lp["ffn"]["norm"], eps),
                        spec, prec)
    return act(x + m_r * y, prec), psum, top1


def stack(params: dict, spec: dict, tokens: torch.Tensor, prec: str,
          remat: bool = False):
    """Final-normed hidden states (B, S, D) of ``tokens`` (B, S) at
    positions 0..S-1, and each layer's ``(probabilities summed, top-1
    counts)`` over its tokens."""
    x = act(params["embed"][tokens] * spec["embedding_multiplier"], prec)
    stats = []
    for i, kind in enumerate(kinds(spec)):
        lp = layer(params, i)
        if remat:
            x, psum, top1 = checkpoint(
                lambda lp_, x_, kind_=kind: block(lp_, x_, kind_, spec, prec),
                lp, x, use_reentrant=False)
        else:
            x, psum, top1 = block(lp, x, kind, spec, prec)
        stats.append((psum, top1))
    return rms_norm(x, params["final_norm"], spec["rms_norm_eps"]), stats


def hidden(params: dict, spec: dict, tokens: torch.Tensor, prec: str,
           remat: bool = False) -> torch.Tensor:
    return stack(params, spec, tokens, prec, remat)[0]


def head(params: dict, spec: dict, x: torch.Tensor, prec: str):
    """Logits over the vocabulary (the tied table's first rows), divided
    by ``logits_scaling``."""
    return mm(x, params["embed"][:spec["vocab_size"]].T, prec) \
        / spec["logits_scaling"]


def _row_nll(params, spec, x, targets, prec):
    return nll_sum(head(params, spec, x, prec), targets)


def loss_and_grads(params: dict, spec: dict, tokens: torch.Tensor,
                   prec: str = "float32"):
    """The port's training loss on ``tokens`` (B, S): the mean next-token
    NLL plus 0.01 times the layers' aux losses over all B * S tokens,
    and its gradient for every leaf. The forward runs a row at a time
    with each layer (and each row's head) recomputed in the backward;
    one backward takes the whole batch's loss, since the aux loss is not
    a sum over rows. Returns ``(loss, {path: grad})``."""
    from portbench.reference.tree import paths
    z = _dims(spec)
    leaves = dict(paths(params))
    for t in leaves.values():
        t.requires_grad_(True)
        t.grad = None
    b, s = tokens.shape
    count = b * (s - 1)
    nll = 0.0
    stats = []
    for r in range(b):
        row = tokens[r:r + 1]
        x, row_stats = stack(params, spec, row, prec, remat=True)
        nll = nll + checkpoint(_row_nll, params, spec, x[:, :-1],
                               row[:, 1:], prec, use_reentrant=False)
        stats.append(row_stats)
    aux = 0.0
    for per_layer in zip(*stats):
        psum = sum(p for p, _ in per_layer) / (b * s)
        top1 = sum(c for _, c in per_layer) / (b * s)
        aux = aux + z["experts"] * (psum * top1).sum()
    loss = nll / count + AUX_WEIGHT * aux
    loss.backward()
    # a held expert that no token routed to takes no part in the loss:
    # its gradient is zero (autograd leaves it None)
    grads = {p: t.grad if t.grad is not None else torch.zeros_like(t)
             for p, t in leaves.items()}
    for t in leaves.values():
        t.requires_grad_(False)
        t.grad = None
    return float(loss.detach()), grads
