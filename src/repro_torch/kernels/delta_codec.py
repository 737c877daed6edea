"""Row-wise absmax int8 codec wrappers — counterpart of the reference's
Pallas ``kernels/delta_codec.py``.

``quantize_rows`` is the pusher's encode (``Int8Transform.encode`` under
the torch codec backend); ``dequantize_rows`` the scatter's decode
(``Int8Transform.decode``). The CUDA kernels (``csrc/delta_codec.cu``)
give codes and scales bit-equal to the NumPy codec
(``Int8Transform._quantize_np``).

Each wrapper dispatches on its tensors' device: CPU tensors take the
plain version in ``kernels/ref.py``; CUDA tensors launch the kernel (or
raise — there is no fallback). Each wrapper's ``launches`` attribute
counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("delta_codec")
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.quantize_rows.argtypes = [p, ll, ll, p, p, p]
    lib.dequantize_rows.argtypes = [p, p, ll, ll, p, p]
    lib.quantize_rows.restype = ctypes.c_int
    lib.dequantize_rows.restype = ctypes.c_int
    return lib


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 quantization.

    Args:
      x: (B, D) rows, cast to float32.
    Returns ``(q int8 (B, D), scale float32 (B, 1))``.
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
    _build.launch("quantize_rows", _lib().quantize_rows, x.device,
                  x.data_ptr(), x.shape[0], x.shape[1], q.data_ptr(),
                  scale.data_ptr())
    quantize_rows.launches += 1
    return q, scale


quantize_rows.launches = 0


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_rows``: ``q * scale``.

    Args:
      q: (B, D) int8 codes.
      scale: (B, 1) per-row scales, cast to float32.
    Returns (B, D) float32.
    """
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
    _build.launch("dequantize_rows", _lib().dequantize_rows, q.device,
                  q.data_ptr(), scale.data_ptr(), q.shape[0], q.shape[1],
                  out.data_ptr())
    dequantize_rows.launches += 1
    return out


dequantize_rows.launches = 0
