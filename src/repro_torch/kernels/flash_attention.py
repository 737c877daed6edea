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
"""

from __future__ import annotations

import ctypes
import functools

import torch

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
                    causal: bool = True) -> torch.Tensor:
    """Blocked online-softmax GQA attention.

    Args:
      q: (B, H, S, D) queries, NOT pre-scaled (``D^-0.5`` is applied
        inside: to q on float32 values, or on the card in bfloat16 to the
        float32 scores, whose probabilities are then rounded to bfloat16
        for P.V).
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
    if _build.on_cpu(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal)
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
                      d ** -0.5)
    else:
        strides = (ctypes.c_longlong * 12)(*(
            st for x in (q, k, v, out) for st in x.stride()[:3]))
        _build.launch("flash_attention", _lib().flash_attention, q.device,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), strides, b, h, g, s, t, d, int(causal),
                      _build.DTYPE_CODES[q.dtype], d ** -0.5)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
