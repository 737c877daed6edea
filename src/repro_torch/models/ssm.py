"""Mamba-2 (SSD — state-space duality) blocks: the chunked scan for
training and prefill (quadratic within a chunk, linear across chunks) and
the O(1)-state decode step — the counterpart of the reference's
``models/ssm.py``, with its names, signatures and dtypes.

Follows the SSD formulation of arXiv:2405.21060 (single B/C group):
    h_t = exp(dt_t·A) h_{t-1} + dt_t · x_t ⊗ B_t        (state (H, P, N))
    y_t = C_t · h_t + D ⊙ x_t

The reference computes the SSD with XLA einsums and a ``lax.scan``
outside any Pallas kernel; the port computes it with tensor ops and
batched products, and the inter-chunk recurrence as a Python loop over
the chunks. Two deliberate departures, each exact where the reference
runs:

- The intra-chunk decay ``L`` masks the upper triangle BEFORE the
  exponential (``exp(seg.masked_fill(~causal, -inf))``). The reference
  takes ``exp`` over the whole square and zeroes the upper triangle
  after, where ``seg`` sums up to ``chunk - 1`` steps of ``dt·|A|``: at
  a chunk of 256 with dt ≈ 1 that overflows to inf, and the backward's
  ``0 * inf`` makes its gradient NaN. The forward values are the same.
- A decode step with a cache of another dtype than the activations (a
  float32 conv state beside bfloat16 activations) runs in the promoted
  dtype, as JAX would, keeps the new conv state in the cache's dtype and
  casts the mixer's output to the activations' dtype, as the attention
  decode does. The reference returns the promoted dtype there, which its
  ``decode_step`` scan refuses (``TypeError``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import _build
from repro_torch.models.common import rms_norm


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the promoted dtype of the two, as a JAX einsum
    computes it (no cast when they agree)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``) at every x: ``F.softplus`` switches to the
    identity above x = 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d. x (B,S,C); w (K,C); b (C,).

    Returns (y (B,S,C), new_state (B,K-1,C)). ``state`` carries the last
    K-1 inputs for decode continuity (zeros for a fresh sequence); the
    concatenation runs in the promoted dtype of state and x, the new
    state comes back in the state's dtype. The K taps are summed from 0
    in tap order, then the bias is added, as in the reference."""
    k, s = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    dt = torch.promote_types(state.dtype, x.dtype)
    xp = torch.cat([state.to(dt), x.to(dt)], dim=1)          # (B, S+K-1, C)
    y = sum(xp[:, i:i + s] * w[i] for i in range(k)) + b
    new_state = xp[:, s:].to(state.dtype) if k > 1 else state
    return y, new_state


def ssd_chunked(x, dt, A, B, C, chunk: int,
                initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x (b,s,h,p); dt (b,s,h) positive; A (h,) negative; B, C (b,s,n).
    Returns (y (b,s,h,p) in x's dtype, final_state (b,h,p,n) float32).

    The reference's three-operand einsums are contracted pairwise, so no
    intermediate is larger than the (b, nc, h, l, l) decay: ``y_diag``
    as one batched product over (b, c, h) of (CB * L) (i, j) by xdt
    (j, p); ``states`` as (xdt * decay) by B over l; ``y_off`` as C by
    the carried-in state over n, then times its decay.
    """
    b, s_orig, h, p = x.shape
    n = B.shape[-1]
    pad = (-s_orig) % chunk
    if pad:
        # zero-pad: dt=0 gives decay exp(0)=1 and zero input contribution,
        # so padded steps are identity on the state and emit garbage rows
        # that are sliced off below.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    s = s_orig + pad
    nc, l = s // chunk, chunk
    xdt = (x * dt[..., None]).float().reshape(b, nc, l, h, p)
    dA = (dt * A).float().reshape(b, nc, l, h)
    Bc = B.reshape(b, nc, l, n).float()
    Cc = C.reshape(b, nc, l, n).float()

    dA_cs = torch.cumsum(dA, dim=2)                          # (b,nc,l,h)

    # --- intra-chunk (quadratic within the chunk) ----------------------
    cs = dA_cs.transpose(2, 3)                               # (b,nc,h,l)
    seg = cs[..., :, None] - cs[..., None, :]                # (b,nc,h,i,j)
    causal = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(seg.masked_fill(~causal, float("-inf")))  # masked first
    CB = Cc @ Bc.transpose(-1, -2)                           # (b,nc,i,j)
    y_diag = (CB[:, :, None] * L) @ xdt.transpose(2, 3)      # (b,nc,h,i,p)

    # --- chunk states ---------------------------------------------------
    decay_states = torch.exp(dA_cs[:, :, -1:] - dA_cs)       # (b,nc,l,h)
    states = torch.einsum("bclhp,bcln->bchpn",
                          xdt * decay_states[..., None], Bc)

    # --- inter-chunk recurrence ------------------------------------------
    chunk_decay = torch.exp(dA_cs[:, :, -1])                 # (b,nc,h)
    carry = (initial_state.float() if initial_state is not None
             else x.new_zeros((b, h, p, n)).float())
    prev = []                                                # PREVIOUS state
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (b,nc,h,p,n)

    # --- contribution of carried-in state --------------------------------
    state_decay = torch.exp(dA_cs)                           # (b,nc,l,h)
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, prev_states) \
        * state_decay[..., None]

    y = (y_diag.transpose(2, 3) + y_off).reshape(b, s, h, p)
    return y[:, :s_orig].to(x.dtype), carry


def _ssd_sharded(x, dt, A, B, C, chunk: int, initial_state=None):
    """``ssd_chunked`` on ``DTensor``s, forward and backward on local
    shards: the scan is independent a (sequence, head), so each mesh dim
    splits the batch (where x's batch is split, or where x must move and
    the batch divides) or the heads (where x's heads are split or the
    heads divide), else replicates."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _build.mesh_of(x)
    px = _build.placements_of(x, mesh)
    b, h = x.shape[0], x.shape[2]
    tensors = (x, dt, A, B, C, initial_state)
    batch = (Shard(0), Shard(0), Replicate()) + (Shard(0),) * 5
    heads = (Shard(2), Shard(2), Shard(0), Replicate(), Replicate(),
             Shard(1), Shard(2), Shard(1))
    picks = []
    for i, n in enumerate(mesh.shape):
        d = _build.shard_dim(px[i])
        if n == 1:
            pick = (Replicate(),) * 8
        elif d == 0 or (d != 2 and b % n == 0):
            pick, b = batch, -(-b // n)
        elif h % n == 0:
            pick, h = heads, h // n
        else:
            pick = (Replicate(),) * 8
        picks.append(pick)
    pl = [tuple(p[j] for p in picks) for j in range(8)]
    ins = [pl[j] if isinstance(t, torch.Tensor) else None
           for j, t in enumerate(tensors)]
    # x, dt, A, B, C in order; ssd_chunked's ``chunk`` rides in the closure
    return _build.local_map(
        lambda x_, dt_, a_, b_, c_, s_: ssd_chunked(
            x_, dt_, a_, b_, c_, chunk, initial_state=s_),
        tensors, ins, [pl[6], pl[7]],
        [x.shape, (x.shape[0], x.shape[2], x.shape[3], B.shape[-1])], mesh)


def ssd_decode_step(state, x, dt, A, B, C):
    """Single-token recurrence. state (b,h,p,n); x (b,h,p); dt (b,h);
    A (h,); B, C (b,n). Returns (y (b,h,p) in x's dtype, new_state)."""
    decay = torch.exp((dt * A).float())                      # (b,h)
    upd = (x * dt[..., None]).float()[..., None] \
        * B.float()[:, None, None, :]                        # (b,h,p,n)
    new_state = state * decay[:, :, None, None] + upd
    if _build.dtensor_args(new_state):
        # the product without folding (b, h) into one batch dim: DTensor
        # cannot fold a head split under a batch split into a bmm
        y = (new_state * C.float()[:, None, None, :]).sum(-1)
    else:
        y = (new_state @ C.float()[:, None, :, None])[..., 0]
    return y.to(x.dtype), new_state


def _projections(p: dict, x: torch.Tensor, cfg: ModelConfig):
    z = _mm(x, p["wz"])
    xin = _mm(x, p["wx"])
    Bv = _mm(x, p["wB"])
    Cv = _mm(x, p["wC"])
    dt_raw = _mm(x, p["wdt"])
    return z, xin, Bv, Cv, dt_raw


def _gate_out(p: dict, y: torch.Tensor, z: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """The gated norm (at ``cfg.norm_eps``) and the output projection: the
    gate in float32, cast back to y's dtype before ``rms_norm``."""
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["gnorm"],
                 cfg.norm_eps)
    return _mm(y, p["out_proj"])


def mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                initial_state=None, return_state: bool = False):
    """Full Mamba-2 mixer for train/prefill. x (B,S,D) -> (B,S,D)."""
    b, s, d = x.shape
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_num_heads
    hp = cfg.ssm_head_dim
    z, xin, Bv, Cv, dt_raw = _projections(p, x, cfg)

    conv_in = torch.cat([xin, Bv, Cv], dim=-1)               # (B,S,di+2n)
    conv_out, _ = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    conv_out = F.silu(conv_out)
    xin = conv_out[..., :di]
    Bv = conv_out[..., di:di + ns]
    Cv = conv_out[..., di + ns:]

    dt = _softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(b, s, nh, hp)
    if _build.dtensor_args(xh):
        y, final_state = _ssd_sharded(xh, dt, A, Bv, Cv, cfg.ssm_chunk,
                                      initial_state)
    else:
        y, final_state = ssd_chunked(xh, dt, A, Bv, Cv, cfg.ssm_chunk,
                                     initial_state=initial_state)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
    out = _gate_out(p, y.reshape(b, s, di), z, cfg)
    if return_state:
        return out, final_state
    return out


def mamba_decode_step(p: dict, x: torch.Tensor, conv_state: torch.Tensor,
                      ssm_state: torch.Tensor, cfg: ModelConfig):
    """One-token decode. x (B,1,D); conv_state (B,K-1,di+2n); ssm_state
    (B,H,P,N) fp32. Returns (out (B,1,D) in x's dtype, conv_state in its
    own dtype, ssm_state) — new tensors; the caller writes them back."""
    b = x.shape[0]
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_num_heads
    hp = cfg.ssm_head_dim
    z, xin, Bv, Cv, dt_raw = _projections(p, x, cfg)

    conv_in = torch.cat([xin, Bv, Cv], dim=-1)               # (B,1,di+2n)
    conv_out, conv_state = _causal_conv(conv_in, p["conv_w"], p["conv_b"],
                                        state=conv_state)
    conv_out = F.silu(conv_out)
    xin = conv_out[..., :di]
    Bv = conv_out[..., di:di + ns]
    Cv = conv_out[..., di + ns:]

    dt = _softplus(dt_raw.float() + p["dt_bias"].float())[:, 0]   # (B,H)
    A = -torch.exp(p["A_log"].float())
    xh = xin[:, 0].reshape(b, nh, hp)
    y, ssm_state = ssd_decode_step(ssm_state, xh, dt, A, Bv[:, 0], Cv[:, 0])
    y = y + p["D"].to(y.dtype)[None, :, None] * xh
    out = _gate_out(p, y.reshape(b, 1, di), z, cfg)
    return out.to(x.dtype), conv_state, ssm_state
