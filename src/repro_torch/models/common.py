"""Shared LM building blocks: token embedding, norm, rotary embedding,
initializer — the counterpart of the reference's ``models/common.py``.

The reference's ``mesh_axis_names`` and ``subkey`` have no counterpart:
the port runs on one card without a mesh, and draws from explicit
``torch.Generator``s instead of JAX keys.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops


class _EmbedTokens(torch.autograd.Function):
    """Token-embedding gather whose gradient is a row scatter-add. The
    reference writes ``embed[tokens]`` and XLA differentiates the gather;
    here the forward is ``ops.embedding_lookup`` and the backward
    ``ops.embedding_scatter_add`` into a zeros table of the param's
    dtype: the transpose of the gather, duplicate tokens accumulating."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, tokens: torch.Tensor):
        ids = tokens.reshape(-1).to(torch.int32)
        ctx.save_for_backward(ids)
        ctx.table_shape = table.shape
        rows = ops.embedding_lookup(table, ids)
        return rows.view(*tokens.shape, table.shape[1])

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (ids,) = ctx.saved_tensors
        d_table = torch.zeros(ctx.table_shape, dtype=grad.dtype,
                              device=grad.device)
        ops.embedding_scatter_add(d_table, ids,
                                  grad.reshape(-1, ctx.table_shape[1]))
        return d_table, None


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``: (V, D) table, integer tokens of any shape ->
    tokens.shape + (D,), in the table's dtype. Forward through the
    ``embedding_lookup`` kernel, gradient through
    ``embedding_scatter_add`` (plain versions on CPU tensors)."""
    return _EmbedTokens.apply(table, tokens)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 with a ``(1 + scale)`` gain, cast back to
    ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary position embedding on dimension halves (GPT-NeoX style).

    x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S).
    The angles are ``positions * theta ** -(arange(half) / half)`` in
    fp32; the rotation runs in fp32 and is cast back to ``x.dtype``.
    """
    half = x.shape[-1] // 2
    freq = torch.arange(half, dtype=torch.float32, device=x.device) / half
    inv_freq = torch.pow(theta, -freq)      # float32, no host-to-device copy
    angles = positions.float()[..., None] * inv_freq          # (..., S, half)
    angles = angles[..., None, :]                             # (..., S, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_init(gen: torch.Generator, shape: tuple[int, ...],
               in_axis_size: int, dtype: torch.dtype) -> torch.Tensor:
    """Scaled-normal initializer (variance 1/fan_in), drawn in fp32 from
    ``gen`` on ``gen``'s device and cast to ``dtype``."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * in_axis_size ** -0.5).to(dtype)
