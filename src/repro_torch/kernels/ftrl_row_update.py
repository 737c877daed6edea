"""FTRL-proximal row update wrappers — counterpart of the reference's
Pallas ``kernels/ftrl_row_update.py``.

``ftrl_row_update`` is the Pallas kernel's function on contiguous rows
(``FTRL.update_rows(backend="torch")``). ``ftrl_apply_slots`` is the
master shard's fused training push after its probe
(``ops.fused_ftrl_apply``): rows gathered through the map's slots,
updated and written back into the arenas in place, in one pass. Both
entries share one CUDA source (``csrc/ftrl_row_update.cu``), a thread a
float, whose element update uses round-to-nearest intrinsics, so their
rows are bit-equal to the NumPy route.

Each wrapper checks its tensors, then dispatches on their device: CPU
tensors take the plain version in ``kernels/ref.py``; CUDA tensors
launch the kernel (or raise — there is no fallback). Both add to
``ftrl_row_update.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import torch

from repro_torch.kernels import _build, ref


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ftrl_row_update")
    p, ll, f, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, \
        ctypes.c_int
    lib.ftrl_row_update.argtypes = [p, p, p, ll, f, f, f, f, p, p, p, p]
    lib.ftrl_apply_slots.argtypes = [p, p, p, p, p, p, i, p, ll, ll, f, f, f,
                                     f, p, p, p, p]
    lib.ftrl_row_update.restype = ctypes.c_int
    lib.ftrl_apply_slots.restype = ctypes.c_int
    return lib


MAX_COUNT = 2 ** 31 - 1           # the kernel's element offsets are 32-bit
# the w arena's types, by the C entry's code; w' is rounded to them
W_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_count(count: int) -> None:
    if count > MAX_COUNT:
        raise ValueError(f"{count} elements: the FTRL kernel takes at most "
                         f"2^31 - 1")


def ftrl_row_update(z: torch.Tensor, n: torch.Tensor, g: torch.Tensor, *,
                    alpha: float = 0.05, beta: float = 1.0, l1: float = 1.0,
                    l2: float = 1.0):
    """One FTRL-proximal step over gathered rows.

    Args:
      z, n, g: (B, D) rows (cast to float32), one shape.
      alpha, beta, l1, l2: hyper-parameters, each rounded to float32 once.
    Returns ``(z', n', w')``, each (B, D) float32. One launch.
    """
    if z.dim() != 2 or z.shape != n.shape or z.shape != g.shape:
        raise ValueError(f"z, n, g must be (B, D) of one shape, got "
                         f"{tuple(z.shape)}, {tuple(n.shape)}, "
                         f"{tuple(g.shape)}")
    _check_count(z.numel())
    if _build.on_cpu(z, n, g):
        return ref.ftrl_row_update(z, n, g, alpha=alpha, beta=beta, l1=l1,
                                   l2=l2)
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


def _check_slots(pos, found, slot_of, z_arena, n_arena, w_arena,
                 grads) -> None:
    """``ftrl_apply_slots``' argument checks, the same on every device."""
    b = pos.shape[0] if pos.dim() == 1 else -1
    for name, t, dtype in (("pos", pos, torch.int32),
                           ("found", found, torch.bool),
                           ("slot_of", slot_of, torch.int32)):
        if t.dim() != 1 or t.dtype != dtype:
            raise ValueError(f"{name} must be 1-D {dtype}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if found.shape[0] != b:
        raise ValueError(f"found has {found.shape[0]} rows, pos {b}")
    for name, t in (("z_arena", z_arena), ("n_arena", n_arena)):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"{name} must be (R, D) float32, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if w_arena.dtype not in W_DTYPES:
        raise ValueError(f"w_arena is {w_arena.dtype}; the FTRL kernel "
                         f"writes w' as one of {list(W_DTYPES)}")
    if n_arena.shape != z_arena.shape or w_arena.shape != z_arena.shape:
        raise ValueError(f"arenas must share one (R, D) shape, got "
                         f"{tuple(z_arena.shape)}, {tuple(n_arena.shape)}, "
                         f"{tuple(w_arena.shape)}")
    for name, t in (("z_arena", z_arena), ("n_arena", n_arena),
                    ("w_arena", w_arena)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous: the pass updates "
                             f"it in place")
    if grads.shape != (b, z_arena.shape[1]):
        raise ValueError(f"grads must be ({b}, {z_arena.shape[1]}), got "
                         f"{tuple(grads.shape)}")
    _check_count(grads.numel())


def ftrl_apply_slots(pos: torch.Tensor, found: torch.Tensor,
                     slot_of: torch.Tensor, z_arena: torch.Tensor,
                     n_arena: torch.Tensor, w_arena: torch.Tensor,
                     grads: torch.Tensor, *, alpha: float, beta: float,
                     l1: float, l2: float):
    """The fused train push after its probe, in one pass: a row's arena
    slot is ``slot_of[pos]`` where ``found``, else 0; ``(z, n)`` are read
    from the arenas there, updated by FTRL-proximal with ``grads``, and
    ``(z', n', w')`` written back into the arenas IN PLACE (``w'`` rounded
    to nearest even where the w arena is float16 or bfloat16) and into the
    returned row outputs.

    The ids behind ``pos`` must be UNIQUE and PRESENT (the reference's
    contract). An absent id reads and writes arena row 0, where two such
    rows race on the card; ``SparseTable.fused_ftrl_update`` raises then
    and drops the mirror's arenas, so no such state survives.

    Args:
      pos, found: (B,) int32 and bool, the probe's results.
      slot_of: (C,) int32, the map's value table (key slot → arena slot).
      z_arena, n_arena: (R, D) float32; w_arena: (R, D) float32, float16
        or bfloat16; all contiguous.
      grads: (B, D) gradient rows (cast to float32).
      alpha, beta, l1, l2: hyper-parameters, each rounded to float32 once.
    Returns ``(z', n', w')``, each (B, D) float32. One launch; no host
    synchronisation, so a call can be captured in a CUDA graph. Raises
    ``ValueError`` for arguments of another dtype, shape or layout.
    """
    _check_slots(pos, found, slot_of, z_arena, n_arena, w_arena, grads)
    kw = dict(alpha=alpha, beta=beta, l1=l1, l2=l2)
    if _build.on_cpu(pos, found, slot_of, z_arena, n_arena, w_arena, grads):
        return ref.ftrl_apply_slots(pos, found, slot_of, z_arena, n_arena,
                                    w_arena, grads, **kw)
    pos, found, slot_of = (t.contiguous() for t in (pos, found, slot_of))
    grads = grads.to(torch.float32).contiguous()
    outs = tuple(torch.empty_like(grads) for _ in range(3))
    if grads.numel() == 0:
        return outs
    _build.launch("ftrl_apply_slots", _lib().ftrl_apply_slots, grads.device,
                  pos.data_ptr(), found.data_ptr(), slot_of.data_ptr(),
                  z_arena.data_ptr(), n_arena.data_ptr(), w_arena.data_ptr(),
                  W_DTYPES[w_arena.dtype], grads.data_ptr(), grads.shape[0],
                  grads.shape[1], float(alpha), float(beta), float(l1),
                  float(l2), *(o.data_ptr() for o in outs))
    ftrl_row_update.launches += 1
    return outs
