"""Row-wise absmax int8 codec wrappers — counterpart of the reference's
Pallas ``kernels/delta_codec.py``.

``quantize_rows`` is the pusher's encode (``Int8Transform.encode`` under
the torch codec backend, and ``ModelSyncEngine``'s dense leaves, each ONE
row, under ``--codec int8``); ``dequantize_rows`` the scatter's decode
(``Int8Transform.decode``). The CUDA kernels (``csrc/delta_codec.cu``)
give codes and scales bit-equal to the NumPy codec
(``Int8Transform._quantize_np``), NaN and Inf rows included, through a
plan by row width (``codec_plan``): a thread, a warp or a block a row,
or one row split over the whole card.

Each wrapper dispatches on its tensors' device: CPU tensors take the
plain version in ``kernels/ref.py``; CUDA tensors launch the kernel (or
raise — there is no fallback). Each wrapper's ``launches`` attribute
counts its kernel launches.

``dequantize_rows`` (the int8 KV cache's read on the LM decode path) is
also the custom op ``repro_torch::dequantize_rows`` (fake: an empty
(B, D) float32 tensor; FLOPs one multiply an element; bytes: the codes
and scales read, the float32 rows written), which the wrapper calls
under a dispatch mode or on fake tensors; its sharding rule splits the
codes by rows (the scales with them) or by columns (the scales
replicated).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, ref


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("delta_codec")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.quantize_rows.argtypes = [p, ll, ll, p, p, p, i, i, i, p]
    lib.dequantize_rows.argtypes = [p, p, ll, ll, p, i, i, p]
    lib.quantize_rows.restype = ctypes.c_int
    lib.dequantize_rows.restype = ctypes.c_int
    return lib


# the plan's regimes, in the C entries' order, and their width limits
REGIMES = ("narrow", "warp", "block", "split")
NARROW_MAX = 16                   # a thread owns a row of <= 16 elements
WARP_MAX = 32 * 64                # a warp holds the row: 64 floats a lane
BLOCK_MAX = 8 * WARP_MAX          # a block of 8 warps holds the row
SPLIT_TILE = 4096                 # elements of a split row's tile
MAX_ROW = 2 ** 31 - 1             # the kernels' in-row offsets are 32-bit


class CodecPlan(NamedTuple):
    """How the codec kernels cover (B, D) rows: ``regime`` (a thread, a
    warp or a block a row, or the row split into ``SPLIT_TILE``-element
    tiles over the whole card) and ``word``, the float32 bytes a lane
    loads at once (16: a float4, with 4-byte code words; 4: one float and
    one code byte)."""
    regime: str
    word: int

    @property
    def quantize_launches(self) -> int:
        """Kernel launches of one ``quantize_rows`` call: a split row takes
        an absmax pass and a code pass. ``dequantize_rows`` takes one."""
        return 2 if self.regime == "split" else 1


def codec_plan(d: int, f32_ptr: int = 0, code_ptr: int = 0) -> CodecPlan:
    """The plan for rows of ``d`` elements whose float32 side (``x`` or
    ``out``) starts at address ``f32_ptr`` and int8 side at ``code_ptr``:
    the regime by width, and float4 words where ``d % 4 == 0`` and both
    pointers are 16-byte aligned. Raises ``ValueError`` for a row the
    kernels cannot index (``d`` not in [1, 2^31))."""
    if not 1 <= d <= MAX_ROW:
        raise ValueError(f"rows of {d} elements: the codec kernels take "
                         f"1 to 2^31 - 1")
    word = 16 if d % 4 == 0 and (f32_ptr | code_ptr) % 16 == 0 else 4
    regime = ("narrow" if d <= NARROW_MAX else "warp" if d <= WARP_MAX
              else "block" if d <= BLOCK_MAX else "split")
    return CodecPlan(regime, word)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 quantization.

    Args:
      x: (B, D) rows, cast to float32.
    Returns ``(q int8 (B, D), scale float32 (B, 1))``. A row holding a NaN
    gets scale NaN, one holding an Inf scale inf, and a NaN quotient code
    0, as in the reference. One launch, two for a split row; no host
    synchronisation, so a call can be captured in a CUDA graph.
    """
    if _build.on_cpu(x):
        return ref.quantize_rows(x)
    if x.dim() != 2:
        raise ValueError(f"x must be (B, D), got {tuple(x.shape)}")
    x = x.to(torch.float32).contiguous()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((x.shape[0], 1), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return q, scale
    plan = codec_plan(x.shape[1], x.data_ptr(), q.data_ptr())
    args = (x.data_ptr(), x.shape[0], x.shape[1], q.data_ptr(),
            scale.data_ptr())
    regime = REGIMES.index(plan.regime)
    if plan.regime == "split":
        # the per-row absmax bits the first pass atomicMax-es into
        absmax = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
        for phase in (1, 2):
            _build.launch("quantize_rows", _lib().quantize_rows, x.device,
                          *args, absmax.data_ptr(), regime, plan.word, phase)
            quantize_rows.launches += 1
    else:
        _build.launch("quantize_rows", _lib().quantize_rows, x.device,
                      *args, None, regime, plan.word, 0)
        quantize_rows.launches += 1
    return q, scale


quantize_rows.launches = 0


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_rows``: ``q * scale``.

    Args:
      q: (B, D) int8 codes.
      scale: (B, 1) per-row scales, cast to float32.
    Returns (B, D) float32. One launch.
    """
    if _build.direct(q, scale):
        return _dequantize(q, scale)
    if _build.dtensor_args(q, scale):
        return _dequantize_sharded(q, scale)
    return torch.ops.repro_torch.dequantize_rows(q, scale)


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The call on plain tensors: the plain version on the CPU, the
    kernel on the card."""
    if _build.on_cpu(q, scale):
        return ref.dequantize_rows(q, scale)
    if q.dtype != torch.int8 or q.dim() != 2:
        raise ValueError(f"q must be (B, D) int8, got {q.dtype} "
                         f"{tuple(q.shape)}")
    if scale.shape != (q.shape[0], 1):
        raise ValueError(f"scale must be ({q.shape[0]}, 1), got "
                         f"{tuple(scale.shape)}")
    q = q.contiguous()
    scale = scale.to(torch.float32).contiguous()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    plan = codec_plan(q.shape[1], out.data_ptr(), q.data_ptr())
    _build.launch("dequantize_rows", _lib().dequantize_rows, q.device,
                  q.data_ptr(), scale.data_ptr(), q.shape[0], q.shape[1],
                  out.data_ptr(), REGIMES.index(plan.regime), plan.word)
    dequantize_rows.launches += 1
    return out


dequantize_rows.launches = 0


@torch.library.custom_op("repro_torch::dequantize_rows", mutates_args=())
def _dequantize_op(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return _dequantize(q, scale)


@_dequantize_op.register_fake
def _(q, scale):
    return q.new_empty(q.shape, dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.dequantize_rows)
def _dequantize_flops(q_shape, *args, out_shape=None, **kwargs) -> int:
    return q_shape[0] * q_shape[1]


_build.OP_BYTES[torch.ops.repro_torch.dequantize_rows.default] = \
    lambda args, kwargs, out: _build.nbytes(args[0], args[1], out)


def _dequantize_sharded(q, scale):
    """The sharding rule, a mesh dim at a time (a dim of size 1 keeps its
    placements): rows split where the codes' or the scales' rows are, or
    where the codes' columns are not and something must move; columns
    split where the codes' columns are (the scales replicated); else
    replicated."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _build.mesh_of(q, scale)
    pq = list(_build.placements_of(q, mesh))
    ps = list(_build.placements_of(scale, mesh))
    out = []
    for i, n in enumerate(mesh.shape):
        if n == 1:
            out.append(Replicate())
            continue
        dq, ds = _build.shard_dim(pq[i]), _build.shard_dim(ps[i])
        if dq == 1:
            pq[i], ps[i] = Shard(1), Replicate()
        elif 0 in (dq, ds):
            pq[i], ps[i] = Shard(0), Shard(0)
        else:
            pq[i], ps[i] = Replicate(), Replicate()
        out.append(pq[i])
    return _build.local_map(torch.ops.repro_torch.dequantize_rows,
                            (q, scale), [tuple(pq), tuple(ps)], tuple(out),
                            q.shape, mesh)
