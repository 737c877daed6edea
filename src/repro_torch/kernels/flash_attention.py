"""Blocked online-softmax GQA attention wrapper (prefill) — counterpart of
the reference's Pallas ``kernels/flash_attention.py``.

The port's ``models/attention.py`` ``self_attention`` calls it for global
causal layers, where the reference's model calls an XLA analogue of the
same function. The CUDA kernel (``csrc/flash_attention.cu``) takes any
strides whose last axis is contiguous, so the caller may pass q, k and v
as transposed views of its (B, S, heads, D) projections; the output has
q's strides.

The wrapper dispatches on its tensors' device: CPU tensors take the
plain version in ``kernels/ref.py``; CUDA tensors launch the kernel (or
raise — there is no fallback). ``flash_attention.launches`` counts its
kernel launches.

It is also the custom op ``repro_torch::flash_attention`` (fake: an
empty tensor like q; FLOPs: ``4 D`` a (query, key) pair the causal mask
keeps, QKᵀ and PV; bytes: q, k, v read and the output written once),
which the wrapper calls under a dispatch mode or on fake tensors, and
whose sharding rule (``_sharded``) runs it on ``DTensor`` shards split
by batch or by heads (q's and k/v's heads together, so each shard keeps
the H:G ratio the kernel maps heads by), else replicated.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, ref

HEAD_DIMS = (64, 128, 256)                  # the kernels' instantiations
TMA_STRIDE_LIMIT = 1 << 40                  # bytes, a tensor map's strides


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                                    ctypes.c_float, p]
    lib.flash_attention.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_sm90() -> ctypes.CDLL:
    lib = _build.load("flash_attention_sm90")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_sm90.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                         ctypes.c_float, p]
    lib.flash_attention_sm90.restype = ctypes.c_int
    return lib


def _tma_strides(x: torch.Tensor) -> tuple[int, int, int]:
    """The (batch, head, row) element strides of a bf16 (B, N, R, D)
    tensor as its TMA map takes them: an axis of size 1 gets 8 (16 bytes,
    never stepped over); any other stride must be positive and under
    2^40 bytes, else ``ValueError``."""
    out = []
    for size, st in zip(x.shape[:3], x.stride()[:3]):
        if size == 1:
            st = 8
        elif not 0 < st * x.element_size() < TMA_STRIDE_LIMIT:
            raise ValueError(f"stride {st} of a {tuple(x.shape)} tensor "
                             f"cannot be described by a TMA map")
        out.append(st)
    return tuple(out)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Blocked online-softmax GQA attention.

    Args:
      q: (B, H, S, D) queries, NOT pre-scaled (``scale``, default
        ``D^-0.5``, is applied inside: to q on float32 values, or on the
        card in bfloat16 to the float32 scores, whose probabilities are
        then rounded to bfloat16 for P.V).
      k, v: (B, G, T, D) with ``H % G == 0``; head h reads group
        ``h // (H // G)``. One dtype for q, k and v: float32 or bfloat16.
      causal: mask key index > query index (by index, as the TPU kernel).
    Returns (B, H, S, D) in ``q.dtype`` (on the card, with q's strides).
    S and T are any lengths >= 1; on the card D is 64, 128 or 256.
    """
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, H, S, D) and k, v one (B, G, T, D) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    g, t = k.shape[1], k.shape[2]
    if (k.shape[0], k.shape[3]) != (b, d) or g < 1 or h % g or t < 1:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}: need (B, G, T >= 1, D), H % G "
                         f"== 0")
    if _build.direct(q, k, v):
        return _run(q, k, v, causal, scale)
    if _build.dtensor_args(q, k, v):
        return _sharded(q, k, v, causal, scale)
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, scale)


def _run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         causal: bool, scale: Optional[float] = None) -> torch.Tensor:
    """The checked call on plain tensors: the plain version on the CPU,
    the kernel on the card."""
    b, h, s, d = q.shape
    g, t = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    if _build.on_cpu(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, scale=scale)
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported on the card "
                         f"({HEAD_DIMS})")
    if (q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    q, k, v = (_build.rows_aligned(x) for x in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if q.dtype == torch.bfloat16:
        strides = (ctypes.c_longlong * 12)(
            *(st for x in (q, k, v) for st in _tma_strides(x)),
            *out.stride()[:3])
        _build.launch("flash_attention_sm90",
                      _lib_sm90().flash_attention_sm90, q.device,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), strides, b, h, g, s, t, d, int(causal),
                      scale)
    else:
        strides = (ctypes.c_longlong * 12)(*(
            st for x in (q, k, v, out) for st in x.stride()[:3]))
        _build.launch("flash_attention", _lib().flash_attention, q.device,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), strides, b, h, g, s, t, d, int(causal),
                      _build.DTYPE_CODES[q.dtype], scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        causal: bool, scale: Optional[float] = None) -> torch.Tensor:
    out = _run(q, k, v, causal, scale)
    if out.stride() != q.stride():      # the fake's layout: q's strides
        out = torch.empty_like(q).copy_(out)
    return out


@_op.register_fake
def _(q, k, v, causal, scale=None):
    return torch.empty_like(q)


def kept_pairs(s: int, t: int, causal: bool) -> int:
    """(query, key) pairs the kernel computes: every one, or with the
    causal mask (key index <= query index) ``sum_i min(i + 1, t)``."""
    if not causal:
        return s * t
    m = min(s, t)
    return m * (m + 1) // 2 + (s - m) * t


def flops(q_shape, k_shape, causal: bool) -> int:
    """QKᵀ and PV: ``2 D`` each a kept pair a head."""
    b, h, s, d = q_shape
    return 4 * b * h * d * kept_pairs(s, k_shape[2], causal)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flop_formula(q_shape, k_shape, v_shape, causal, *args, out_shape=None,
                  **kwargs) -> int:
    return flops(q_shape, k_shape, causal)


_build.OP_BYTES[torch.ops.repro_torch.flash_attention.default] = \
    lambda args, kwargs, out: _build.nbytes(*args[:3], out)


def _sharded(q, k, v, causal: bool, scale: Optional[float] = None):
    """The op on ``DTensor``s through ``shard_plan``."""
    ins, out, mesh = shard_plan(q, k, v)
    return _build.local_map(
        lambda q_, k_, v_: torch.ops.repro_torch.flash_attention(
            q_, k_, v_, causal, scale),
        (q, k, v), ins, out, q.shape, mesh)


def shard_plan(q, k, v):
    """The sharding rule, ``(placements of q, k, v; of the output;
    mesh)``: a mesh dim of size 1 keeps every placement;
    else q, k, v and the output are split on batch where any of them is
    (or, if none is split there, where something must move and the
    batch left divides), on heads where the heads left and the groups
    left both divide, else replicated. A query sequence or a head dim
    split (the reference's context-parallel and head_dim layouts) is
    redistributed to one of these: the kernel masks by index, so a
    query shard could not know its offset."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _build.mesh_of(q, k, v)
    pls = [_build.placements_of(x, mesh) for x in (q, k, v)]
    b, h, g = q.shape[0], q.shape[1], k.shape[1]
    ins = [list(p) for p in pls]
    out = []
    for i, n in enumerate(mesh.shape):
        if n == 1:
            out.append(Replicate())
            continue
        dims = {_build.shard_dim(p[i]) for p in pls}
        moved = any(not isinstance(p[i], Replicate) for p in pls)
        heads = h % n == 0 and g % n == 0
        if 0 in dims or (moved and b % n == 0):
            pick, b = Shard(0), -(-b // n)
        elif moved and heads:
            pick, h, g = Shard(1), h // n, g // n
        else:
            pick = Replicate()
        for p in ins:
            p[i] = pick
        out.append(pick)
    return [tuple(p) for p in ins], tuple(out), mesh
