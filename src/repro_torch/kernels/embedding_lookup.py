"""Row gather and row scatter-set wrappers — counterpart of the
reference's Pallas ``kernels/embedding_lookup.py``.

``embedding_lookup`` is the serve path's row gather (cache arena and
replica tables); ``embedding_scatter`` re-uploads dirty arena rows into a
device mirror in place. The CUDA kernels (``csrc/embedding_lookup.cu``)
copy rows as raw bytes, so every dtype is bit-exact and any row width
works.

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
    lib = _build.load("embedding_lookup")
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.embedding_lookup.argtypes = [p, ll, p, ll, p, p]
    lib.embedding_scatter.argtypes = [p, ll, p, ll, p, p]
    lib.embedding_lookup.restype = ctypes.c_int
    lib.embedding_scatter.restype = ctypes.c_int
    return lib


def _check_table_ids(table: torch.Tensor, ids: torch.Tensor) -> None:
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous (V, D) tensor, got "
                         f"{tuple(table.shape)}")
    if ids.dtype != torch.int32 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError(f"ids must be a contiguous 1-D int32 tensor, got "
                         f"{ids.dtype} {tuple(ids.shape)}")


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Batched row gather: ``out[i] = table[ids[i]]``.

    Args:
      table: (V, D) any dtype — the arena.
      ids: (N,) int32, in bounds (callers resolve slots first; the CUDA
        kernel does not check).
    Returns (N, D) rows, same dtype as ``table``.
    """
    if _build.on_cpu(table, ids):
        return ref.embedding_lookup(table, ids)
    _check_table_ids(table, ids)
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if out.numel() == 0:
        return out
    _build.launch("embedding_lookup", _lib().embedding_lookup,
                  table.device, table.data_ptr(),
                  table.shape[1] * table.element_size(), ids.data_ptr(),
                  ids.shape[0], out.data_ptr())
    embedding_lookup.launches += 1
    return out


embedding_lookup.launches = 0


def embedding_scatter(table: torch.Tensor, ids: torch.Tensor,
                      updates: torch.Tensor) -> torch.Tensor:
    """Row scatter-SET in place: ``table[ids[i]] = updates[i]``.

    Args:
      table: (V, D) — written in place (the reference's aliased output).
      ids: (N,) int32, UNIQUE and in bounds.
      updates: (N, D), cast to ``table.dtype``.
    Returns ``table``.
    """
    if _build.on_cpu(table, ids, updates):
        return ref.embedding_scatter(table, ids, updates)
    _check_table_ids(table, ids)
    updates = updates.to(table.dtype).contiguous()
    if updates.shape != (ids.shape[0], table.shape[1]):
        raise ValueError(f"updates {tuple(updates.shape)} do not match "
                         f"{ids.shape[0]} ids x {table.shape[1]} columns")
    if updates.numel() == 0:
        return table
    _build.launch("embedding_scatter", _lib().embedding_scatter,
                  table.device, table.data_ptr(),
                  table.shape[1] * table.element_size(), ids.data_ptr(),
                  ids.shape[0], updates.data_ptr())
    embedding_scatter.launches += 1
    return table


embedding_scatter.launches = 0
