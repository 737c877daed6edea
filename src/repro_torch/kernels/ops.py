"""Public kernel entry points of the port — the counterpart of the
reference's jitted ``kernels/ops.py``.

Where the reference picks interpret mode off the TPU, the port dispatches
on the tensors' device inside each wrapper: CUDA tensors launch the
hand-written kernels, CPU tensors run the plain versions in
``kernels/ref.py``. ``fused_lookup`` (serve) and ``fused_ftrl_apply``
(train) chain probe → slot translate → gather (→ FTRL → scatter) without
a host hop, as the reference's jits do. ``flash_attention`` (prefill) and
``decode_attention`` (decode) are the LM serving path's kernels;
``embedding_lookup`` gathers the LM's token embeddings and
``embedding_scatter_add`` is their gradient in training.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import delta_codec as _dc
from repro_torch.kernels import embedding_lookup as _el
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ftrl_row_update as _ftrl
from repro_torch.kernels import hashmap_probe as _hm

embedding_lookup = _el.embedding_lookup
embedding_scatter = _el.embedding_scatter
embedding_scatter_add = _el.embedding_scatter_add
ftrl_row_update = _ftrl.ftrl_row_update
quantize_rows = _dc.quantize_rows
dequantize_rows = _dc.dequantize_rows
flash_attention = _fa.flash_attention
decode_attention = _da.decode_attention

# every hand-written kernel wrapper of the port, each with its
# ``launches`` counter
KERNELS = {"hashmap_probe": _hm.hashmap_probe,
           "hashmap_probe_hbm": _hm.hashmap_probe_hbm,
           "embedding_lookup": _el.embedding_lookup,
           "embedding_scatter": _el.embedding_scatter,
           "embedding_scatter_add": _el.embedding_scatter_add,
           "ftrl_row_update": _ftrl.ftrl_row_update,
           "quantize_rows": _dc.quantize_rows,
           "dequantize_rows": _dc.dequantize_rows,
           "flash_attention": _fa.flash_attention,
           "decode_attention": _da.decode_attention}


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


def fused_ftrl_apply(keys: torch.Tensor, slot_of: torch.Tensor,
                     z_arena: torch.Tensor, n_arena: torch.Tensor,
                     w_arena: torch.Tensor, ids: torch.Tensor,
                     grads: torch.Tensor, *, shift: int, alpha: float,
                     beta: float, l1: float, l2: float,
                     placement: str = "auto"):
    """The sparse training hot path against a device-resident table
    mirror: probe → slot translate → gather ``(z, n)`` → FTRL row update
    → scatter ``(z', n', w')`` back into the arenas, no host hop.

    ``ids`` must be UNIQUE and PRESENT in the map (``MasterShard`` runs
    ``ensure`` first); ``found`` is returned so the caller can check it
    — a missing id reads and writes arena row 0. The port updates the
    three arenas IN PLACE where the reference donates them to its jit
    and returns new ones. Returns ``(z', n', w', found)``: the row
    outputs (B, D) for the host-authoritative arrays, and the (B,) found
    mask."""
    pos, found = hashmap_probe(keys, ids, shift=shift, placement=placement)
    slot = torch.where(found, slot_of[pos], torch.zeros_like(pos))
    z = embedding_lookup(z_arena, slot)
    n = embedding_lookup(n_arena, slot)
    z2, n2, w2 = ftrl_row_update(z, n, grads, alpha=alpha, beta=beta,
                                 l1=l1, l2=l2)
    embedding_scatter(z_arena, slot, z2)
    embedding_scatter(n_arena, slot, n2)
    embedding_scatter(w_arena, slot, w2)
    return z2, n2, w2, found
