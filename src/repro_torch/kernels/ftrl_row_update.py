"""FTRL-proximal row update wrapper — counterpart of the reference's
Pallas ``kernels/ftrl_row_update.py``.

The master shard's fused training route (``ops.fused_ftrl_apply``) and
``FTRL.update_rows(backend="torch")`` call it on gathered ``(z, n)`` rows
and gradient rows. The CUDA kernel (``csrc/ftrl_row_update.cu``) updates
one element per thread with round-to-nearest intrinsics, so its rows are
bit-equal to the NumPy route.

The wrapper dispatches on its tensors' device: CPU tensors take the
plain version in ``kernels/ref.py``; CUDA tensors launch the kernel (or
raise — there is no fallback). ``ftrl_row_update.launches`` counts its
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ftrl_row_update")
    p, ll, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    lib.ftrl_row_update.argtypes = [p, p, p, ll, f, f, f, f, p, p, p, p]
    lib.ftrl_row_update.restype = ctypes.c_int
    return lib


def ftrl_row_update(z: torch.Tensor, n: torch.Tensor, g: torch.Tensor, *,
                    alpha: float = 0.05, beta: float = 1.0, l1: float = 1.0,
                    l2: float = 1.0):
    """One FTRL-proximal step over gathered rows.

    Args:
      z, n, g: (B, D) rows (cast to float32), one shape.
      alpha, beta, l1, l2: hyper-parameters, each rounded to float32 once.
    Returns ``(z', n', w')``, each (B, D) float32.
    """
    if _build.on_cpu(z, n, g):
        return ref.ftrl_row_update(z, n, g, alpha=alpha, beta=beta, l1=l1,
                                   l2=l2)
    if z.dim() != 2 or z.shape != n.shape or z.shape != g.shape:
        raise ValueError(f"z, n, g must be (B, D) of one shape, got "
                         f"{tuple(z.shape)}, {tuple(n.shape)}, "
                         f"{tuple(g.shape)}")
    z, n, g = (t.to(torch.float32).contiguous() for t in (z, n, g))
    outs = tuple(torch.empty_like(z) for _ in range(3))
    if z.numel() == 0:
        return outs
    _build.launch("ftrl_row_update", _lib().ftrl_row_update, z.device,
                  z.data_ptr(), n.data_ptr(), g.data_ptr(), z.numel(),
                  float(alpha), float(beta), float(l1), float(l2),
                  *(o.data_ptr() for o in outs))
    ftrl_row_update.launches += 1
    return outs


ftrl_row_update.launches = 0
