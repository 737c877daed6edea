"""Plain reference of a Mamba-2 stack (mamba2): float32 (TF32 off) or the
control's fp8, no kernels.

Per layer, on ``h = rms_norm(x)``: z, x, B, C and dt projections; a
depthwise causal conv with bias and SiLU over (x, B, C); dt =
softplus(dt + dt_bias), A = -exp(A_log); the SSD scan written as in the
paper's minimal listing (arXiv:2405.21060, "ssd_minimal_discrete": the
segment sums, the diagonal blocks, the chunk states, the inter-chunk
recurrence and the state-to-output term), one group for B and C; ``y +
D * x``; a gated RMSNorm of ``y * silu(z)``; the out projection; the
residual. A final norm and the tied head. Also the model's operation
counts for the per-layer readers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.common import (STACK, act, mm, nll_sum,
                                        padded_vocab, rms_norm,
                                        shared_leaves, single_segment)


def _dims(spec: dict):
    d = spec["hidden_size"]
    di = spec["expand"] * d
    return d, di, spec["state_size"], di // spec["head_dim"], spec["head_dim"]


def leaf_specs(spec: dict) -> dict:
    """``{path: (shape, init, arg, float32)}`` of every parameter in the
    port's layout (``weights.make_leaf``): per layer the norm, the z, x,
    B, C and dt projections, the conv's weight and bias, A (as log A, in
    U[1, 16]), D = 1, dt's bias (dt log-uniform in [1e-3, 1e-1]), the
    gated norm and the out projection; A, D and dt's bias in float32."""
    d, di, n, nh, _ = _dims(spec)
    layers, k = spec["num_hidden_layers"], spec["conv_kernel"]
    ch = di + 2 * n
    mx = f"{STACK}/mixer"
    out = shared_leaves(spec)
    out.update({
        f"{mx}/norm": ((layers, d), "normal", 0.1, False),
        f"{mx}/wz": ((layers, d, di), "normal", d ** -0.5, False),
        f"{mx}/wx": ((layers, d, di), "normal", d ** -0.5, False),
        f"{mx}/wB": ((layers, d, n), "normal", d ** -0.5, False),
        f"{mx}/wC": ((layers, d, n), "normal", d ** -0.5, False),
        f"{mx}/wdt": ((layers, d, nh), "normal", d ** -0.5, False),
        f"{mx}/conv_w": ((layers, k, ch), "normal", k ** -0.5, False),
        f"{mx}/conv_b": ((layers, ch), "normal", 0.1, False),
        f"{mx}/A_log": ((layers, nh), "uniform_log", (1.0, 16.0), True),
        f"{mx}/D": ((layers, nh), "ones", None, True),
        f"{mx}/dt_bias": ((layers, nh), "dt_bias", (1e-3, 1e-1), True),
        f"{mx}/gnorm": ((layers, di), "normal", 0.1, False),
        f"{mx}/out_proj": ((layers, di, d), "normal", di ** -0.5, False)})
    return out


def port_segments(spec: dict, base):
    """The port's segments: the registered Mamba-2 pattern, one layer a
    repeat."""
    return single_segment(spec, base)


def matmul_params(spec: dict) -> int:
    """Parameters each token multiplies: the in projections to z, x, B,
    C and dt, the out projection, and the head over the padded table."""
    d, di, n, nh, _ = _dims(spec)
    per_layer = d * (2 * di + 2 * n + nh) + di * d
    return spec["num_hidden_layers"] * per_layer + padded_vocab(spec) * d


def _ssd_flops(spec: dict, batch: int, seq: int) -> float:
    """The SSD's products of a forward, counted over the whole (l, l)
    square of each chunk: CB, the diagonal blocks, the chunk states and
    the state-to-output term."""
    _, _, n, nh, hp = _dims(spec)
    l = spec["chunk_size"]
    chunks = -(-seq // l)
    per_chunk = 2.0 * l * l * n + 2.0 * nh * l * l * hp + 4.0 * nh * l * hp * n
    return batch * chunks * per_chunk * spec["num_hidden_layers"]


def forward_flops(spec: dict, batch: int, seq: int) -> float:
    return 2.0 * batch * seq * matmul_params(spec) + _ssd_flops(spec, batch,
                                                                seq)


def train_flops(spec: dict, batch: int, seq: int) -> float:
    """A train step: three times the forward (remat's recompute not
    counted)."""
    return 3.0 * forward_flops(spec, batch, seq)


def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): the sum of x[j+1..i] at (i, j) for i >= j,
    -inf above the diagonal."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    below = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device),
                       diagonal=-1)
    x = x.masked_fill(~below, 0.0)
    out = torch.cumsum(x, dim=-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return out.masked_fill(~keep, float("-inf"))


def ssd(X, A, B, C, block: int):
    """X (b, s, h, p) = x * dt; A (b, s, h) = dt * A; B, C (b, s, n), one
    group; s a multiple of ``block``. Returns y (b, s, h, p)."""
    b, s, h, p = X.shape
    c = s // block
    X = X.reshape(b, c, block, h, p)
    A = A.reshape(b, c, block, h).permute(0, 3, 1, 2)       # b h c l
    B = B.reshape(b, c, block, -1)
    C = C.reshape(b, c, block, -1)
    a_cs = torch.cumsum(A, dim=-1)
    L = torch.exp(segsum(A))                                 # b h c l s
    cb = torch.einsum("bcln,bcsn->bcls", C, B)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", L * cb[:, None], X)
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)          # b h c l
    xd = X * decay_states.permute(0, 2, 3, 1)[..., None]
    states = torch.einsum("bcln,bclhp->bchpn", B, xd)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(a_cs[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    y_off = torch.einsum("bcln,bchpn->bclhp", C, states) \
        * torch.exp(a_cs).permute(0, 2, 3, 1)[..., None]
    return (y_diag + y_off).reshape(b, s, h, p)


def layer(params: dict, i: int) -> dict:
    return {k: v[i] for k, v in
            params["segments"][0]["pos0"]["mixer"].items()}


def block(lp: dict, x: torch.Tensor, spec: dict, prec: str) -> torch.Tensor:
    """One Mamba-2 layer with its residual over x (B, S, D)."""
    eps = spec["rms_norm_eps"]
    d, di, n, nh, hp = _dims(spec)
    b, s, _ = x.shape
    h = rms_norm(x, lp["norm"], eps)
    z = mm(h, lp["wz"], prec)
    u = torch.cat([mm(h, lp["wx"], prec), mm(h, lp["wB"], prec),
                   mm(h, lp["wC"], prec)], dim=-1)
    k = lp["conv_w"].shape[0]
    up = F.pad(u, (0, 0, k - 1, 0))
    conv = sum(up[:, i:i + s] * lp["conv_w"][i] for i in range(k))
    u = F.silu(conv + lp["conv_b"])
    xin, bb, cc = u[..., :di], u[..., di:di + n], u[..., di + n:]
    dt = F.softplus(mm(h, lp["wdt"], prec) + lp["dt_bias"], threshold=1e9)
    a = -torch.exp(lp["A_log"])
    xh = xin.reshape(b, s, nh, hp)
    pad = (-s) % spec["chunk_size"]
    y = ssd(F.pad(xh * dt[..., None], (0, 0, 0, 0, 0, pad)),
            F.pad(dt * a, (0, 0, 0, pad)), F.pad(bb, (0, 0, 0, pad)),
            F.pad(cc, (0, 0, 0, pad)), spec["chunk_size"])[:, :s]
    y = y + lp["D"][:, None] * xh
    y = rms_norm(y.reshape(b, s, di) * F.silu(z), lp["gnorm"], eps)
    return act(x + mm(y, lp["out_proj"], prec), prec)


def hidden(params: dict, spec: dict, tokens: torch.Tensor, prec: str,
           remat: bool = False) -> torch.Tensor:
    x = act(params["embed"][tokens], prec)
    for i in range(spec["num_hidden_layers"]):
        lp = layer(params, i)
        if remat:
            x = checkpoint(lambda lp_, x_: block(lp_, x_, spec, prec), lp, x,
                           use_reentrant=False)
        else:
            x = block(lp, x, spec, prec)
    return rms_norm(x, params["final_norm"], spec["rms_norm_eps"])


def head(params: dict, spec: dict, x: torch.Tensor, prec: str):
    return mm(x, params["embed"][:spec["vocab_size"]].T, prec)


def loss_and_grads(params: dict, spec: dict, tokens: torch.Tensor,
                   prec: str = "float32"):
    """Mean next-token NLL of ``tokens`` (B, S) and its gradient for every
    leaf, a row at a time with each layer recomputed in the backward.
    Returns ``(loss, {path: grad})``."""
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
