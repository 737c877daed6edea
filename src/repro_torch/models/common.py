"""Shared LM building blocks: norm, rotary embedding, initializer — the
counterpart of the reference's ``models/common.py``.

The reference's ``mesh_axis_names`` and ``subkey`` have no counterpart:
the port runs on one card without a mesh, and draws from explicit
``torch.Generator``s instead of JAX keys.
"""

from __future__ import annotations

import torch


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
