"""Hash-map probe wrappers — the device-resident half of
``core.hashmap.IdHashMap``, counterpart of the reference's Pallas
``kernels/hashmap_probe.py``.

Both placements resolve a batch of int64 ids against the map's int64 key
table and return ``(pos int32, found bool)``, bit-equal to
``IdHashMap._probe`` where found (``kernels/ref.py`` states the
contract). Keys stay int64 on the device: the reference's uint32 limbs
only existed because the TPU has no int64 vector arithmetic.

  * ``hashmap_probe`` ("vmem" placement): one thread per id walks the
    table in place (``csrc/hashmap_probe.cu``, ``probe_walk_kernel``).
  * ``hashmap_probe_hbm``: one warp per id reads 256-slot windows of the
    wrap-padded table (``probe_window_kernel``).

``ops.hashmap_probe`` routes between them on capacity against
``VMEM_SLOT_BOUND``, decision for decision as the reference does.

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

_WINDOW = ref._WINDOW               # must match core.hashmap._WINDOW
_DMA_WINDOW = ref._DMA_WINDOW       # slots per id per window pass
# Capacity above which ops.hashmap_probe routes to the windowed kernel:
# 2^21 slots are 16 MiB of keys, which the H100's 50 MB L2 holds across a
# batch (the TPU bound was VMEM; kept so routing matches the reference).
VMEM_SLOT_BOUND = 1 << 21

wrap_pad = ref.wrap_pad


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("hashmap_probe")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.hashmap_probe_walk.argtypes = [p, ll, i, p, ll, p, p, p]
    lib.hashmap_probe_window.argtypes = [p, ll, i, i, p, ll, p, p, p]
    lib.hashmap_probe_walk.restype = ctypes.c_int
    lib.hashmap_probe_window.restype = ctypes.c_int
    return lib


def _check(keys: torch.Tensor, ids: torch.Tensor, shift: int,
           pad: int) -> int:
    """The capacity, after checking the kernel's exact layout: ``cap +
    pad`` int64 key slots and int64 ids, 1-D and contiguous."""
    cap = 1 << (64 - int(shift))
    if not 16 <= cap <= 1 << 31:
        raise ValueError(f"shift {shift}: capacity must be in [2^4, 2^31]")
    for name, t in (("keys", keys), ("ids", ids)):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int64 tensor,"
                             f" got {t.dtype} {tuple(t.shape)}")
    if keys.shape[0] != cap + pad:
        raise ValueError(f"key table has {keys.shape[0]} slots, the kernel "
                         f"reads exactly {cap + pad}")
    return cap


def _outputs(ids: torch.Tensor):
    n = ids.shape[0]
    return (torch.empty(n, dtype=torch.int32, device=ids.device),
            torch.empty(n, dtype=torch.bool, device=ids.device))


def hashmap_probe(keys: torch.Tensor, ids: torch.Tensor, *,
                  shift: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Probe by walking the key table in place (the "vmem" placement).

    Args:
      keys: (C,) int64 — the map's key table, C = ``2**(64 - shift)``.
      ids: (N,) int64 query ids.
      shift: the map's Fibonacci shift.

    Returns ``(pos (N,) int32, found (N,) bool)``; see ``kernels/ref.py``.
    """
    if _build.on_cpu(keys, ids):
        return ref.hashmap_probe(keys, ids, shift=shift)
    cap = _check(keys, ids, shift, 0)
    pos, found = _outputs(ids)
    if ids.shape[0] == 0:
        return pos, found
    _build.launch("hashmap_probe", _lib().hashmap_probe_walk, ids.device,
                  keys.data_ptr(), cap, int(shift), ids.data_ptr(),
                  ids.shape[0], pos.data_ptr(), found.data_ptr())
    hashmap_probe.launches += 1
    return pos, found


hashmap_probe.launches = 0


def hashmap_probe_hbm(keys: torch.Tensor, ids: torch.Tensor, *,
                      shift: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Probe by 256-slot windows of a wrap-padded key table — same
    contract and results as ``hashmap_probe``, for maps past
    ``VMEM_SLOT_BOUND`` or tables pinned to the "hbm" placement.

    Args:
      keys: (C + min(256, C),) int64 — the key table wrap-padded by
        ``wrap_pad`` (the device mirror keeps it so).
      ids: (N,) int64 query ids.
      shift: the map's Fibonacci shift; C = ``2**(64 - shift)``.
    """
    if _build.on_cpu(keys, ids):
        return ref.hashmap_probe_hbm(keys, ids, shift=shift)
    w = min(_DMA_WINDOW, 1 << (64 - int(shift)))
    cap = _check(keys, ids, shift, w)
    pos, found = _outputs(ids)
    if ids.shape[0] == 0:
        return pos, found
    _build.launch("hashmap_probe_hbm", _lib().hashmap_probe_window,
                  ids.device, keys.data_ptr(), cap, int(shift), w,
                  ids.data_ptr(), ids.shape[0], pos.data_ptr(),
                  found.data_ptr())
    hashmap_probe_hbm.launches += 1
    return pos, found


hashmap_probe_hbm.launches = 0
