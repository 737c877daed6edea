"""Single-token GQA attention against a ragged KV cache (flash-decode)
wrapper — counterpart of the reference's Pallas
``kernels/decode_attention.py``.

The port's ``models/attention.py`` ``decode_self_attention`` calls it for
global layers against a full-precision cache, where the reference's model
writes the same function inline. The CUDA source
(``csrc/decode_attention.cu``) splits each sequence's cache across blocks,
reads only the cache rows below each sequence's length, combines the
splits in a fixed order within the same launch, and takes q and the cache
in their own dtypes (float32 or bfloat16 each). The dtypes choose one of
two kernels: a bfloat16 query against a bfloat16 cache runs the
tensor-core kernel under ``mma_split_plan``; every other pair runs the
CUDA-core kernel under ``split_plan``.

The wrapper dispatches on its tensors' device: CPU tensors take the
plain version in ``kernels/ref.py``; CUDA tensors launch the kernel (or
raise — there is no fallback). ``decode_attention.launches`` counts its
kernel launches, ``decode_attention.tensor_core_launches`` those of the
tensor-core kernel (the rest ran the CUDA-core kernel).

It is also the custom op ``repro_torch::decode_attention`` (fake: an
empty (B, H, D) tensor of q's dtype; FLOPs ``4 D`` a cache row a head;
bytes: q, the whole cache, the lengths read and the output written
once — the capacity, since the lengths stay on the card), which the
wrapper calls under a dispatch mode or on fake tensors, and whose
sharding rule (``_sharded``) runs it on ``DTensor`` shards split by
batch or by heads (q's and the cache's together), else replicated. A
sequence-split cache (the reference's flash-decode layout) is gathered
first: the kernel combines its splits in one launch and returns no
log-sum-exp for a cross-shard combine.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, ref

HEAD_DIMS = (64, 128, 256)                  # the kernel's instantiations
MAX_HEADS = 16                      # query heads per KV group on the card
CHUNK = 32                          # cache rows the kernel copies at once
TARGET_BLOCKS = 2 * 132             # twice the H100's SMs
# the tensor-core path (bfloat16 q and cache)
TILE = 64                           # cache rows a block takes a step
MIN_ROWS = 256                      # fewest rows a split holds
MAX_ROWS = 1024                     # most rows a split holds


def split_plan(s: int, b: int, g: int) -> tuple[int, int]:
    """``(splits, rows)``: each (sequence, group) of a (B, S, G, D) cache
    is cut into ``splits`` runs of ``rows`` rows, ``splits * rows >= S``.
    ``rows`` is the largest multiple of ``CHUNK`` (at least one) with
    ``rows * ceil(TARGET_BLOCKS / (B * G)) <= S``, so that ``B * G *
    splits`` covers the card's SMs twice wherever S allows, in as few
    splits as that takes. Depends on the capacity S, never on the lengths,
    which stay on the card."""
    want = -(-TARGET_BLOCKS // (b * g))
    rows = CHUNK * max(1, s // (want * CHUNK))
    return -(-s // rows), rows


def mma_split_plan(s: int, b: int, g: int) -> tuple[int, int]:
    """The tensor-core path's ``(splits, rows)``, ``splits * rows >= S``:
    ``rows`` is ``S * B * G / TARGET_BLOCKS`` rounded up to a multiple of
    ``TILE``, held within ``[MIN_ROWS, MAX_ROWS]``. A short or narrow
    cache then runs about one wave of blocks (two a SM), each walking
    four steps or more, since a block's set-up, its warps' merge and its
    partial cost as much as a few steps; a long one (the decode cell's)
    runs many waves of ``MAX_ROWS``, and no block walks more than that
    alone. Each used split's partial, written and read once, adds about
    ``2 m / rows`` of its rows' bytes (m query heads a group; 1.2% at
    m = 6 and 1,024 rows). Depends on the capacity S, never on the
    lengths."""
    tiles = -(-s * b * g // (TARGET_BLOCKS * TILE))
    rows = TILE * min(MAX_ROWS // TILE, max(MIN_ROWS // TILE, tiles))
    return -(-s // rows), rows


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                     ctypes.c_float, p, p, i, i, p]
    lib.decode_attention.restype = ctypes.c_int
    return lib


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One query token per sequence against its first ``lengths[b]`` cache
    rows.

    Args:
      q: (B, H, D) queries, NOT pre-scaled (``scale``, default ``D^-0.5``,
        is applied inside, on float32 values); float32 or bfloat16.
      k, v: (B, S, G, D) cache with ``H % G == 0``; head h reads group
        ``h // (H // G)``; float32 or bfloat16 (may differ from q's).
      lengths: (B,) integer valid lengths, each in ``[1, S]``. The TPU
        kernel returns zeros for a length of 0 where the reference's
        plain attention returns the mean of V, so 0 is refused: on the
        CPU with ``ValueError``; on the card the kernel fails a
        device-side assert, raised as ``RuntimeError`` at the next
        synchronisation (a host-side check would read the lengths back
        on every call, and no decode step could be captured in a CUDA
        graph).
    Returns (B, H, D) in ``q.dtype``.
    """
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, H, D) and k, v one (B, S, G, D) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, d = q.shape
    s, g = k.shape[1], k.shape[2]
    if (k.shape[0], k.shape[3]) != (b, d) or g < 1 or h % g:
        raise ValueError(f"cache {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}: need (B, S, G, D), H % G == 0")
    if lengths.shape != (b,) or lengths.dtype.is_floating_point:
        raise ValueError(f"lengths must be (B,) integers, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    if _build.direct(q, k, v, lengths):
        return _run(q, k, v, lengths, scale)
    if _build.dtensor_args(q, k, v, lengths):
        return _sharded(q, k, v, lengths, scale)
    return torch.ops.repro_torch.decode_attention(q, k, v, lengths, scale)


def _run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         lengths: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """The checked call on plain tensors: the plain version on the CPU,
    the kernel on the card."""
    b, h, d = q.shape
    s, g = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    if _build.on_cpu(q, k, v, lengths):
        if b and not bool(((lengths >= 1) & (lengths <= s)).all()):
            raise ValueError(f"lengths must lie in [1, {s}], got "
                             f"{lengths.tolist()}")
        return ref.decode_attention(q, k, v, lengths, scale=scale)
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported on the card "
                         f"({HEAD_DIMS})")
    codes = _build.DTYPE_CODES
    if q.dtype not in codes or k.dtype not in codes or v.dtype != k.dtype:
        raise ValueError(f"q and the cache must be float32 or bfloat16 "
                         f"(k and v alike), got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if h // g > MAX_HEADS:
        raise ValueError(f"{h // g} query heads per KV group: the kernel "
                         f"holds at most {MAX_HEADS}")
    q, k, v = (_build.rows_aligned(x) for x in (q, k, v))
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
        out.stride(0), out.stride(1))
    mma = q.dtype == k.dtype == torch.bfloat16
    splits, rows = (mma_split_plan if mma else split_plan)(s, b, g)
    part = torch.empty(b * g * splits * -(-(h // g) * (d + 2) // 4) * 4,
                       dtype=torch.float32, device=q.device)
    tickets = torch.zeros(b * g, dtype=torch.int32, device=q.device)
    _build.launch("decode_attention", _lib().decode_attention, q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), strides, b, h, g, s, d,
                  codes[q.dtype], codes[k.dtype], scale, part.data_ptr(),
                  tickets.data_ptr(), splits, rows)
    decode_attention.launches += 1
    decode_attention.tensor_core_launches += int(mma)
    return out


decode_attention.launches = 0
decode_attention.tensor_core_launches = 0


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def _op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        lengths: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    return _run(q, k, v, lengths, scale)


@_op.register_fake
def _(q, k, v, lengths, scale=None):
    return q.new_empty(q.shape)


def flops(q_shape, k_shape) -> int:
    """q·k and p·v over every cache row: ``4 D`` a row a head."""
    b, h, d = q_shape
    return 4 * b * h * k_shape[1] * d


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _flop_formula(q_shape, k_shape, v_shape, lengths_shape, *args,
                  out_shape=None, **kwargs) -> int:
    return flops(q_shape, k_shape)


_build.OP_BYTES[torch.ops.repro_torch.decode_attention.default] = \
    lambda args, kwargs, out: _build.nbytes(*args[:4], out)


def _sharded(q, k, v, lengths, scale: Optional[float] = None):
    """The sharding rule: a mesh dim of size 1 keeps every placement;
    else everything is split on batch where any of q, the cache or the
    lengths is (or, if none is, where something must move and the batch
    left divides), on heads (q's dim 1, the cache's dim 2, the lengths
    replicated) where the heads and groups left divide, else
    replicated."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _build.mesh_of(q, k, v, lengths)
    pls = [_build.placements_of(x, mesh) for x in (q, k, v, lengths)]
    b, h, g = q.shape[0], q.shape[1], k.shape[2]
    ins = [list(p) for p in pls]
    out = []
    for i, n in enumerate(mesh.shape):
        if n == 1:
            out.append(Replicate())
            continue
        moved = any(not isinstance(p[i], Replicate) for p in pls)
        batch = any(_build.shard_dim(p[i]) == 0 for p in pls)
        if batch or (moved and b % n == 0):
            picks, b = (Shard(0),) * 4, -(-b // n)
        elif moved and h % n == 0 and g % n == 0:
            picks, h, g = (Shard(1), Shard(2), Shard(2), Replicate()), \
                h // n, g // n
        else:
            picks = (Replicate(),) * 4
        for p, pick in zip(ins, picks):
            p[i] = pick
        out.append(picks[0])
    return _build.local_map(
        lambda q_, k_, v_, n_: torch.ops.repro_torch.decode_attention(
            q_, k_, v_, n_, scale), (q, k, v, lengths),
        [tuple(p) for p in ins], tuple(out), q.shape, mesh)
