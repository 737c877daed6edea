"""Row gather, row scatter-set and row scatter-add wrappers — counterpart
of the reference's Pallas ``kernels/embedding_lookup.py``.

``embedding_lookup`` is the serve path's row gather (cache arena and
replica tables) and the LM's token-embedding gather;
``embedding_scatter`` re-uploads dirty arena rows into a device mirror
in place; ``embedding_scatter_add`` is the token gather's gradient (rows
of duplicate ids accumulate). The gather and scatter-set kernels
(``csrc/embedding_lookup.cu``) copy rows as raw bytes, so every dtype is
bit-exact and any row width works, in warp tiles that ``copy_plan``
picks; the scatter-add adds in input order,
rounding to the table's dtype after every add, bit-equal to its plain
version (``scatter_add_word`` gives the bytes each lane adds).

Each wrapper dispatches on its tensors' device: CPU tensors take the
plain version in ``kernels/ref.py``; CUDA tensors launch the kernel (or
raise — there is no fallback). Each wrapper's ``launches`` attribute
counts its kernel launches.

``embedding_lookup`` and ``embedding_scatter_add`` are also the custom
ops ``repro_torch::embedding_lookup`` (fake: an empty (N, D) tensor of
the table's dtype; no FLOPs; bytes: the ids read, N rows read and
written) and ``repro_torch::embedding_scatter_add`` (mutates the table;
FLOPs one add an element of the updates; bytes: the ids and updates
read, N table rows read and written — the most the ids can touch),
which the wrappers call under a dispatch mode or on fake tensors.
Their sharding rules take ``DTensor``s: a vocab-split table gathers
(or adds) the rows in its range on each shard (the rest masked: the
kernels do not check bounds), giving a ``Partial`` output (or taking a
replicated update); a column-split table works on its columns with
the ids replicated; a replicated table follows the ids' split (the
scatter-add into a table ``Partial`` over the token split: each shard
adds its own tokens).
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, ref


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("embedding_lookup")
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    i = ctypes.c_int
    lib.embedding_lookup.argtypes = [p, ll, p, ll, p, i, i, p]
    lib.embedding_scatter.argtypes = [p, ll, p, ll, p, i, i, p]
    lib.embedding_scatter_add.argtypes = [p, ll, p, p, ll, p, ll,
                                          ctypes.c_int, ctypes.c_int, p]
    lib.embedding_lookup.restype = ctypes.c_int
    lib.embedding_scatter.restype = ctypes.c_int
    lib.embedding_scatter_add.restype = ctypes.c_int
    lib.embedding_scatter_add_share.restype = ctypes.c_int
    return lib


# the copy kernels take fewer ids than this
MAX_COPY_IDS = 2 ** 30
# rows of at least this many copy words go a warp a row ("wide"); narrower
# rows go 32 rows to a warp tile
WIDE_WORDS = 32


def _check_table_ids(table: torch.Tensor, ids: torch.Tensor) -> None:
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous (V, D) tensor, got "
                         f"{tuple(table.shape)}")
    if ids.dtype != torch.int32 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError(f"ids must be a contiguous 1-D int32 tensor, got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    if ids.shape[0] >= MAX_COPY_IDS:
        raise ValueError(f"{ids.shape[0]} ids: the copy kernels take "
                         f"< 2^30")


def copy_plan(table: torch.Tensor, rows: torch.Tensor) -> tuple[int, int,
                                                                 bool]:
    """The gather's and scatter-set's plan for a (V, D) table and the
    contiguous (N, D) rows copied out of or into it: ``(word, words,
    wide)``. ``word`` is the bytes a lane moves at a time, the widest of
    16, 8, 4, 2 and 1 that divides both pointers and the row's bytes;
    ``words`` the words a row; ``wide`` whether a warp moves one row at
    a time (``words >= WIDE_WORDS``) or the flat words of a tile of 32
    rows."""
    row_bytes = table.shape[1] * table.element_size()
    m = table.data_ptr() | rows.data_ptr() | row_bytes
    word = next(w for w in (16, 8, 4, 2, 1) if m % w == 0)
    words = row_bytes // word
    return word, words, words >= WIDE_WORDS


def _copy(name: str, cfunc, table: torch.Tensor, ids: torch.Tensor,
          rows: torch.Tensor) -> None:
    word, _, wide = copy_plan(table, rows)
    _build.launch(name, cfunc, table.device, table.data_ptr(),
                  table.shape[1] * table.element_size(), ids.data_ptr(),
                  ids.shape[0], rows.data_ptr(), word, int(wide))


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Batched row gather: ``out[i] = table[ids[i]]``.

    Args:
      table: (V, D) any dtype — the arena.
      ids: (N,) int32, in bounds (callers resolve slots first; the CUDA
        kernel does not check).
    Returns (N, D) rows, same dtype as ``table``.
    """
    if _build.direct(table, ids):
        return _lookup(table, ids)
    if _build.dtensor_args(table, ids):
        return _lookup_sharded(table, ids)
    return torch.ops.repro_torch.embedding_lookup(table, ids)


def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The call on plain tensors: the plain version on the CPU, the
    kernel on the card."""
    if _build.on_cpu(table, ids):
        return ref.embedding_lookup(table, ids)
    _check_table_ids(table, ids)
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if out.numel() == 0:
        return out
    _copy("embedding_lookup", _lib().embedding_lookup, table, ids, out)
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
    _copy("embedding_scatter", _lib().embedding_scatter, table, ids,
          updates)
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
    if _build.direct(table, ids, updates):
        return _scatter_add(table, ids, updates)
    if _build.dtensor_args(table, ids, updates):
        _scatter_add_sharded(table, ids, updates)
    else:
        torch.ops.repro_torch.embedding_scatter_add(table, ids, updates)
    return table


def _scatter_add(table: torch.Tensor, ids: torch.Tensor,
                 updates: torch.Tensor) -> torch.Tensor:
    """The call on plain tensors: the plain version on the CPU, the
    kernel on the card."""
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


# ---------------------------------------------------------------------------
# The custom ops, their counts and their sharding rules
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::embedding_lookup", mutates_args=())
def _lookup_op(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return _lookup(table, ids)


@_lookup_op.register_fake
def _(table, ids):
    return table.new_empty((ids.shape[0], table.shape[1]))


@torch.library.custom_op("repro_torch::embedding_scatter_add",
                         mutates_args=("table",))
def _scatter_add_op(table: torch.Tensor, ids: torch.Tensor,
                    updates: torch.Tensor) -> None:
    _scatter_add(table, ids, updates)


@_scatter_add_op.register_fake
def _(table, ids, updates):
    return None


@register_flop_formula(torch.ops.repro_torch.embedding_lookup)
def _lookup_flops(*args, out_shape=None, **kwargs) -> int:
    return 0


@register_flop_formula(torch.ops.repro_torch.embedding_scatter_add)
def _scatter_add_flops(table_shape, ids_shape, updates_shape, *args,
                       out_shape=None, **kwargs) -> int:
    return ids_shape[0] * table_shape[1]


def lookup_bytes(table, ids) -> int:
    """The ids read, N rows read and N written."""
    return _build.nbytes(ids) + 2 * ids.shape[0] * table.shape[1] \
        * table.element_size()


def scatter_add_bytes(table, ids, updates) -> int:
    """The ids and the updates read, N table rows read and written."""
    return _build.nbytes(ids, updates) + 2 * ids.shape[0] \
        * table.shape[1] * table.element_size()


_build.OP_BYTES[torch.ops.repro_torch.embedding_lookup.default] = \
    lambda args, kwargs, out: lookup_bytes(*args[:2])
_build.OP_BYTES[torch.ops.repro_torch.embedding_scatter_add.default] = \
    lambda args, kwargs, out: scatter_add_bytes(*args[:3])


def _vocab_range(table, placements) -> tuple[int, int]:
    """``(first row, rows)`` of this rank's shard of a ``DTensor`` table
    laid out as ``placements``."""
    shape, offset = _build.local_extent(table.shape, table.device_mesh,
                                        placements)
    return offset[0], shape[0]


def _in_range(ids: torch.Tensor, lo: int, rows: int):
    """``(local ids, mask)``: ids shifted into a shard of ``rows`` rows
    from ``lo``, those outside it set to 0 and masked."""
    rel = ids - lo
    ok = (rel >= 0) & (rel < rows)
    return torch.where(ok, rel, 0).to(torch.int32), ok


def _lookup_sharded(table, ids):
    """The gather's sharding rule, a mesh dim at a time (a dim of size 1
    keeps its placements): a vocab-split table (``Shard(0)``) takes the
    ids replicated and gives a ``Partial`` output, each shard gathering
    the rows in its range; a column-split one (``Shard(1)``) the ids
    replicated and a column-split output; a replicated table the ids'
    split (tokens) or replication. Anything else (a strided split, a
    ``Partial`` table) is replicated first."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = _build.mesh_of(table, ids)
    pt = list(_build.placements_of(table, mesh))
    pi = list(_build.placements_of(ids, mesh))
    out = []
    vocab = False
    for i, n in enumerate(mesh.shape):
        if n == 1:
            out.append(Replicate())
            continue
        d = _build.shard_dim(pt[i])
        if d == 0:
            pi[i], vocab = Replicate(), True
            out.append(Partial())
        elif d == 1:
            pi[i] = Replicate()
            out.append(Shard(1))
        else:
            pt[i] = Replicate()
            di = _build.shard_dim(pi[i])
            pi[i] = Shard(0) if di == 0 else Replicate()
            out.append(pi[i])
    lo, rows = _vocab_range(table, pt) if vocab else (0, table.shape[0])

    def fn(table_, ids_):
        if not vocab:
            return torch.ops.repro_torch.embedding_lookup(table_, ids_)
        local, ok = _in_range(ids_, lo, rows)
        got = torch.ops.repro_torch.embedding_lookup(table_, local)
        return torch.where(ok[:, None], got, 0)

    return _build.local_map(fn, (table, ids), [tuple(pt), tuple(pi)],
                            tuple(out), (ids.shape[0], table.shape[1]),
                            mesh)


def scatter_add_placements(mesh, ids, updates) -> tuple:
    """The placements of a zeros table ``_scatter_add_sharded`` adds
    ``updates`` into without moving them: ``Partial`` where the tokens
    are split, ``Shard(1)`` where the columns are, else replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    pu = _build.placements_of(updates, mesh)
    out = []
    for i, n in enumerate(mesh.shape):
        d = _build.shard_dim(pu[i])
        out.append(Replicate() if n == 1 else Partial() if d == 0
                   else Shard(1) if d == 1 else Replicate())
    return tuple(out)


def _scatter_add_sharded(table, ids, updates) -> None:
    """The scatter-add's sharding rule, a mesh dim at a time, IN PLACE
    on the ``DTensor`` table's shards (a dim of size 1 keeps its
    placements): a ``Partial`` table takes the ids and updates split on
    tokens (each shard adds its own); a column-split table the ids
    replicated and the updates split on columns; a vocab-split one both
    replicated, each shard adding the rows in its range (the rest
    masked to zero rows at its row 0); a replicated one both
    replicated. Any other table placement raises ``ValueError``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(table, DTensor):
        raise ValueError("a scatter-add of DTensor updates needs a DTensor "
                         "table (its placements say how the sums combine)")
    mesh = table.device_mesh
    pt = table.placements
    pi = list(_build.placements_of(ids, mesh))
    pu = list(_build.placements_of(updates, mesh))
    vocab = False
    for i, n in enumerate(mesh.shape):
        if n == 1:
            continue
        d = _build.shard_dim(pt[i])
        if isinstance(pt[i], Partial):
            pi[i], pu[i] = Shard(0), Shard(0)
        elif d == 1:
            pi[i], pu[i] = Replicate(), Shard(1)
        elif d == 0:
            pi[i], pu[i], vocab = Replicate(), Replicate(), True
        elif isinstance(pt[i], Replicate):
            pi[i], pu[i] = Replicate(), Replicate()
        else:
            raise ValueError(f"embedding_scatter_add cannot take a table "
                             f"placed {pt[i]} on mesh dim {i}")
    lo, rows = _vocab_range(table, pt) if vocab else (0, table.shape[0])

    def fn(table_, ids_, updates_):
        if vocab:
            ids_, ok = _in_range(ids_, lo, rows)
            updates_ = torch.where(ok[:, None], updates_, 0)
        torch.ops.repro_torch.embedding_scatter_add(
            table_, ids_, updates_.to(table_.dtype))

    _build.local_map(fn, (table, ids, updates),
                     [tuple(pt), tuple(pi), tuple(pu)], None, None, mesh)
