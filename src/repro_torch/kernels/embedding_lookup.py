"""Row gather, row scatter-set and row scatter-add wrappers — counterpart
of the reference's Pallas ``kernels/embedding_lookup.py``.

``embedding_lookup`` is the serve path's row gather (cache arena and
replica tables) and the LM's token-embedding gather;
``embedding_scatter`` re-uploads dirty arena rows into a device mirror
in place; ``embedding_scatter_add`` is the token gather's gradient (rows
of duplicate ids accumulate). The gather and scatter-set kernels
(``csrc/embedding_lookup.cu``) copy rows as raw bytes, so every dtype is
bit-exact and any row width works; the scatter-add adds in input order,
rounding to the table's dtype after every add, bit-equal to its plain
version (``scatter_add_word`` gives the bytes each lane adds).

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
    lib.embedding_scatter_add.argtypes = [p, ll, p, p, ll, p, ll,
                                          ctypes.c_int, ctypes.c_int, p]
    lib.embedding_lookup.restype = ctypes.c_int
    lib.embedding_scatter.restype = ctypes.c_int
    lib.embedding_scatter_add.restype = ctypes.c_int
    lib.embedding_scatter_add_share.restype = ctypes.c_int
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


def scatter_add_word(table: torch.Tensor, updates: torch.Tensor) -> int:
    """The bytes each lane of the scatter-add kernel adds: 16 where the two
    pointers, the table's row bytes and the updates' row stride allow,
    else 8, 4 or 2. A warp covers a slice of 32 such words of a row."""
    size = table.element_size()
    m = (table.data_ptr() | updates.data_ptr() | table.shape[1] * size
         | updates.stride(0) * size)
    return next(w for w in (16, 8, 4, 2) if m % w == 0)


def embedding_scatter_add(table: torch.Tensor, ids: torch.Tensor,
                          updates: torch.Tensor) -> torch.Tensor:
    """Row scatter-ADD in place: ``table[ids[i]] += updates[i]``, the rows
    of duplicate ids accumulating in input order.

    As the reference's wrapper does, the ids are sorted here with a
    STABLE sort (so a row's duplicates stay in input order). The kernel
    reads the updates in place through the sort's order, and the warps
    of each id's segment add it up in column slices, rounding to
    ``table.dtype`` after every add (see ``csrc/embedding_lookup.cu``).
    Bit-equal to the plain version, and to the Pallas kernel's sequential
    ``+=``. One kernel launch; no host synchronisation, so a call can be
    captured in a CUDA graph.

    Args:
      table: (V, D) float32 or bfloat16, contiguous — updated in place
        (the reference's aliased output).
      ids: (N,) int32 or int64, any order, in bounds (the kernel does
        not check).
      updates: (N, D), cast to ``table.dtype`` before they are added;
        read in place if its last axis is contiguous (and its rows less
        than 4 GB apart).
    Returns ``table``. No ids is a no-op.
    """
    if _build.on_cpu(table, ids, updates):
        return ref.embedding_scatter_add(table, ids, updates)
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous (V, D) tensor, got "
                         f"{tuple(table.shape)}")
    if table.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"table must be float32 or bfloat16, got "
                         f"{table.dtype}")
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ids must be a 1-D int32 or int64 tensor, got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    if updates.shape != (ids.shape[0], table.shape[1]):
        raise ValueError(f"updates {tuple(updates.shape)} do not match "
                         f"{ids.shape[0]} ids x {table.shape[1]} columns")
    if ids.shape[0] >= 2 ** 31:
        raise ValueError(f"{ids.shape[0]} ids: the kernel takes < 2^31")
    if ids.shape[0] == 0 or table.shape[1] == 0:
        return table
    sorted_ids, order = sort_ids(ids)
    upd = updates.to(table.dtype)
    if upd.stride(1) != 1 or upd.stride(0) * upd.element_size() >= 2 ** 32:
        upd = upd.contiguous()
    scatter_add_sorted(table, sorted_ids, order, upd)
    return table


embedding_scatter_add.launches = 0


def sort_ids(ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The scatter-add's stable sort: the sorted ids as int32, and the
    order as ``torch.sort`` returns it (int64, which the kernel reads)."""
    sorted_ids, order = torch.sort(ids, stable=True)
    return sorted_ids.to(torch.int32), order


def scatter_add_sorted(table: torch.Tensor, sorted_ids: torch.Tensor,
                       order: torch.Tensor, upd: torch.Tensor) -> None:
    """The scatter-add kernel alone, on CUDA tensors the wrapper has
    checked: ``sort_ids``' output and updates of the table's dtype whose
    last axis is contiguous. Each launch adds one to
    ``embedding_scatter_add.launches``."""
    word = scatter_add_word(table, upd)
    _build.launch("embedding_scatter_add", _lib().embedding_scatter_add,
                  table.device, table.data_ptr(), table.shape[1],
                  sorted_ids.data_ptr(), order.data_ptr(),
                  sorted_ids.shape[0], upd.data_ptr(), upd.stride(0),
                  _build.DTYPE_CODES[table.dtype], word)
    embedding_scatter_add.launches += 1
