"""Plain PyTorch pieces shared by the references: float32 with TF32 off,
or the control's fp8; the parameter leaves every family has; the
embedding table's padded rows.

``precision`` is ``"float32"`` (the reference) or ``"fp8"`` (the
control: what the program holds in bf16 held in float8 e4m3 instead,
with one absmax scale a tensor: both operands and the product of every
linear layer and of the head, and the residual stream after the
embedding and after each layer; under autograd the backward is rounded
the same way: each product's incoming gradient, the saved operands it
meets and the gradients it gives, and the residual stream's gradient).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

E4M3_MAX = 448.0

# every leaf of a configuration's stack sits under this path of the
# port's parameter dict: one segment, whose one position holds each layer
# leaf stacked on a leading layer axis
STACK = "segments/0/pos0"


def padded_vocab(spec: dict) -> int:
    """Embedding rows: the vocabulary padded to a multiple of 256."""
    return -(-spec["vocab_size"] // 256) * 256


def shared_leaves(spec: dict) -> dict:
    """The leaves outside the stack, in ``leaf_specs``' form: the tied
    table and the final norm's gain."""
    d = spec["hidden_size"]
    return {"embed": ((padded_vocab(spec), d), "normal", d ** -0.5, False),
            "final_norm": ((d,), "normal", 0.1, False)}


def single_segment(spec: dict, base):
    """The port's segments for a configuration whose stack is one
    segment of the registered pattern: that pattern repeated
    ``num_hidden_layers`` times. ``base`` is the port's registered
    configuration."""
    if len(base.segments) != 1 or base.encoder_segments:
        raise ValueError(f"{spec['port_arch']}: only a single-segment "
                         f"decoder stack maps from a layer count")
    return (dataclasses.replace(base.segments[0],
                                repeats=spec["num_hidden_layers"]),)


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under one absmax scale, back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Round(torch.autograd.Function):
    """e4m3 rounding, forward and backward."""

    @staticmethod
    def forward(ctx, x):
        return _e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return _e4m3(g)


class _Matmul(torch.autograd.Function):
    """``a @ w`` with both operands and the product in e4m3; the
    backward rounds the incoming gradient and both gradients it gives,
    against the rounded operands the forward saved."""

    @staticmethod
    def forward(ctx, a, w):
        qa, qw = _e4m3(a), _e4m3(w)
        ctx.save_for_backward(qa, qw)
        return _e4m3(qa @ qw)

    @staticmethod
    def backward(ctx, g):
        qa, qw = ctx.saved_tensors
        qg = _e4m3(g)
        ga = gw = None
        if ctx.needs_input_grad[0]:
            ga = _e4m3(qg @ qw.transpose(-1, -2))
        if ctx.needs_input_grad[1]:
            gw = _e4m3((qa.reshape(-1, qa.shape[-1]).T
                        @ qg.reshape(-1, qg.shape[-1])).reshape(qw.shape))
        return ga, gw


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under one absmax scale, back in float32; its
    gradient rounded the same way."""
    return _Round.apply(x)


def act(x: torch.Tensor, precision: str) -> torch.Tensor:
    """An activation the program holds in bf16: as it is, or in fp8."""
    return fp8_round(x) if precision == "fp8" else x


def mm(a: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ w`` (a (..., k), w (k, n)) in float32, or with both operands
    and the product, forward and backward, in fp8."""
    if precision == "fp8":
        return _Matmul.apply(a, w)
    return a @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with a ``(1 + scale)`` gain."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding on dimension halves: x (..., S, heads, hd),
    positions (..., S); angle ``pos * theta ** -(i / half)``."""
    half = x.shape[-1] // 2
    inv = theta ** -(torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = (positions.double()[..., None] * inv).float()[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def adam_(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
          step: int, opt: dict, held: str = None) -> None:
    """One Adam step in place (bias-corrected, ``step`` counted from 0);
    with ``held`` (a dtype's name) the updated weights rounded to it, as
    a program that keeps its weights in that dtype holds them."""
    b1, b2 = opt["b1"], opt["b2"]
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    t = step + 1
    mhat = m / (1 - b1 ** t)
    vhat = v / (1 - b2 ** t)
    p.sub_(opt["lr"] * mhat / (vhat.sqrt() + opt["eps"]))
    if held is not None:
        p.copy_(p.to(getattr(torch, held)))


def nll_sum(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Summed negative log-likelihood of ``targets`` under ``logits``."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None]).sum()


@torch.no_grad()
def prompt_argmax_gaps(fam, params: dict, spec: dict, tokens: torch.Tensor,
                       served: torch.Tensor, prec: str = "float32",
                       block_rows: int = 1024) -> torch.Tensor:
    """For a prompt ``tokens`` (S,) under the family module ``fam``'s
    reference: at each position, by how much the logit of ``served`` (S,)
    lies below the best logit. Returns (S,) gaps."""
    x = fam.hidden(params, spec, tokens[None], prec)[0]
    out = []
    for s0 in range(0, x.shape[0], block_rows):
        lg = fam.head(params, spec, x[s0:s0 + block_rows], prec)
        pick = lg.gather(-1, served[s0:s0 + block_rows, None].long())[:, 0]
        out.append(lg.max(-1).values - pick)
    return torch.cat(out)


@torch.no_grad()
def prompt_argmax(fam, params: dict, spec: dict, tokens: torch.Tensor,
                  prec: str, block_rows: int = 1024) -> torch.Tensor:
    """The top token at each position of a prompt (S,) under ``fam``'s
    reference in ``prec``."""
    x = fam.hidden(params, spec, tokens[None], prec)[0]
    return torch.cat([fam.head(params, spec, x[s0:s0 + block_rows],
                               prec).argmax(-1)
                      for s0 in range(0, x.shape[0], block_rows)])
