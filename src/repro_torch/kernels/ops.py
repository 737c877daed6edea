"""Public kernel entry points of the port — the counterpart of the
reference's jitted ``kernels/ops.py``.

Where the reference picks interpret mode off the TPU, the port dispatches
on the tensors' device inside each wrapper: CUDA tensors launch the
hand-written kernels, CPU tensors run the plain versions in
``kernels/ref.py``. ``fused_lookup`` chains probe → slot translate →
gather without a host hop, as the reference's jit does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import embedding_lookup as _el
from repro_torch.kernels import hashmap_probe as _hm

embedding_lookup = _el.embedding_lookup
embedding_scatter = _el.embedding_scatter

# every hand-written kernel wrapper on the serving path, each with its
# ``launches`` counter
KERNELS = {"hashmap_probe": _hm.hashmap_probe,
           "hashmap_probe_hbm": _hm.hashmap_probe_hbm,
           "embedding_lookup": _el.embedding_lookup,
           "embedding_scatter": _el.embedding_scatter}


def launch_counts() -> dict[str, int]:
    """``{kernel name: launches}`` over ``KERNELS``."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launches() -> None:
    """Set every kernel's launch counter to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def resolve_placement(shift: int, placement: str = "auto") -> str:
    """``"vmem"`` or ``"hbm"``: ``"auto"`` picks by capacity against
    ``VMEM_SLOT_BOUND``, as the reference routes."""
    if placement == "auto":
        cap = 1 << (64 - int(shift))
        return "hbm" if cap > _hm.VMEM_SLOT_BOUND else "vmem"
    if placement not in ("vmem", "hbm"):
        raise ValueError(f"unknown placement {placement!r}")
    return placement


def hashmap_probe(keys: torch.Tensor, ids: torch.Tensor, *, shift: int,
                  placement: str = "auto"):
    """Placement-routed probe: ``"vmem"`` walks the table in place,
    ``"hbm"`` reads 256-slot windows of the wrap-padded table, ``"auto"``
    picks by capacity. ``keys`` is in the resolved placement's layout:
    exact capacity for ``"vmem"``, wrap-padded for ``"hbm"`` (as
    ``_DeviceMirror`` keeps it). Returns ``(pos int32, found bool)``."""
    if resolve_placement(shift, placement) == "hbm":
        return _hm.hashmap_probe_hbm(keys, ids, shift=shift)
    return _hm.hashmap_probe(keys, ids, shift=shift)


def fused_lookup(keys: torch.Tensor, slot_of: torch.Tensor,
                 arena: torch.Tensor, ids: torch.Tensor, *, shift: int,
                 placement: str = "auto"):
    """Probe → slot translate → gather against a device-resident table
    mirror. ``slot_of`` is the map's value table (key slot → arena slot,
    int32). Returns ``(rows (N, D), found (N,) bool, slot (N,) int32)``:
    missing rows are zeros and their slot is 0."""
    pos, found = hashmap_probe(keys, ids, shift=shift, placement=placement)
    slot = torch.where(found, slot_of[pos], torch.zeros_like(pos))
    rows = embedding_lookup(arena, slot)
    rows = torch.where(found[:, None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return rows, found, slot
