"""Shared LM building blocks: the mesh in scope, token embedding, norm,
rotary embedding, initializer — the counterpart of the reference's
``models/common.py``.

``mesh_scope(m)`` puts a ``sharding.MeshInfo`` in scope (the reference's
``with jax.set_mesh(mesh)``), and ``mesh_axis_names`` reads it: the
model's sharding hints (``constrain_batch``, ``fsdp_gather``,
``attention._context_parallel_constraint``, ``moe._maybe_wsc``) key off
it and stay inert, one attribute read, where no mesh is in scope. The reference's ``subkey`` has no
counterpart: the port draws from explicit ``torch.Generator``s instead
of JAX keys.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import _build, ops


class _Scope:
    """The mesh in scope: process-wide, not a context variable, because
    autograd runs a CUDA backward (and a checkpoint's recompute in it) on
    a thread of its own, which must see the forward's mesh."""
    mesh = None


@contextlib.contextmanager
def mesh_scope(m):
    """Put the ``MeshInfo`` ``m`` (or None) in scope for the block."""
    saved, _Scope.mesh = _Scope.mesh, m
    try:
        yield m
    finally:
        _Scope.mesh = saved


def current_mesh():
    """The ``MeshInfo`` in scope, or None."""
    return _Scope.mesh


def mesh_axis_names() -> tuple:
    """Axis names of the mesh currently in scope, () when mesh-less."""
    m = _Scope.mesh
    return () if m is None else m.axis_names


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Activations (B, ...) laid out as the batch's inputs are (batch on
    the batch axes where B covers ``data``, else replicated) when a mesh
    is in scope; else ``x`` as it is. Where the reference leaves the
    residual stream to GSPMD's propagation, DTensor's op-by-op choices
    (a reduce-scatter of a partial sum onto the sequence, say) would
    drift from it; the model pins it after the embedding and each
    layer."""
    m = _Scope.mesh
    if m is None:
        return x
    from repro_torch.models.sharding import P, logical_axis_constraint
    b_ax = m.batch_axes if x.shape[0] >= m.data else None
    return logical_axis_constraint(x, m, P(b_ax, *([None] * (x.dim() - 1))))


def fsdp_gather(tree):
    """A layer's params as FSDP uses them: with an FSDP layout in scope,
    each ``DTensor`` leaf's split on the batch axes (``data``, ``pod``)
    is gathered (DTensor's all-gather; its backward reduce-scatters the
    gradient), its tensor-parallel split kept; else ``tree`` as it is.
    The reference's GSPMD gathers a weight's FSDP shard at each matmul;
    DTensor's op-by-op choice would instead split the contraction and
    replicate the activations."""
    m = _Scope.mesh
    if m is None or not m.opts.fsdp:
        return tree
    from torch.distributed.tensor import DTensor, Replicate
    batch = [i for i, name in enumerate(m.axis_names)
             if name in m.batch_axes]

    def gather(t):
        if not isinstance(t, DTensor):
            return t
        pl = list(t.placements)
        for i in batch:
            if not pl[i].is_replicate():
                pl[i] = Replicate()
        if tuple(pl) == tuple(t.placements):
            return t
        return t.redistribute(t.device_mesh, pl)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return gather(node)

    return walk(tree)


class _GatherRows(torch.autograd.Function):
    """Row gather whose gradient is a row scatter-add: ``table[ids]``.
    The reference writes the gather as indexing and XLA differentiates
    it; here the forward is ``ops.embedding_lookup`` and the backward
    ``ops.embedding_scatter_add`` into a zeros table of the gradient's
    dtype: the transpose of the gather, rows of duplicate ids
    accumulating in input order (no atomics, so two runs and a remat
    recompute agree to the bit)."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor):
        ids = ids.reshape(-1).to(torch.int32)
        ctx.save_for_backward(ids)
        ctx.table_shape = table.shape
        ctx.table_placements = getattr(table, "placements", None)
        return ops.embedding_lookup(table, ids)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (ids,) = ctx.saved_tensors
        if ctx.table_placements is not None:
            return _sharded_table_grad(ctx, ids, grad), None
        d_table = torch.zeros(ctx.table_shape, dtype=grad.dtype,
                              device=grad.device)
        ops.embedding_scatter_add(d_table, ids, grad)
        return d_table, None


def _sharded_table_grad(ctx, ids, grad):
    """A ``DTensor`` table's gradient: zeros laid out as the scatter-add's
    rule takes ``grad`` (``Partial`` over the token split), the rows
    added, then redistributed to the table's placements (DTensor's
    reduce-scatter or all-reduce)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels.embedding_lookup import scatter_add_placements
    if not isinstance(grad, DTensor):
        raise ValueError("a DTensor table's gradient must be a DTensor")
    mesh = grad.device_mesh
    pl = scatter_add_placements(mesh, ids, grad)
    local = _build.local_extent(ctx.table_shape, mesh, pl)[0]
    zeros = torch.zeros(local, dtype=grad.dtype,
                        device=grad.to_local().device)
    d_table = DTensor.from_local(zeros, mesh, pl, run_check=False,
                                 shape=ctx.table_shape,
                                 stride=zeros.new_empty(
                                     ctx.table_shape, device="meta").stride())
    ops.embedding_scatter_add(d_table, ids, grad)
    return d_table.redistribute(mesh, ctx.table_placements)


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: (V, D) contiguous table, (N,) integer ids in bounds
    -> (N, D) in the table's dtype. Forward through the
    ``embedding_lookup`` kernel, gradient through
    ``embedding_scatter_add`` (plain versions on CPU tensors)."""
    return _GatherRows.apply(table, ids)


class _ScatterRows(torch.autograd.Function):
    """The transpose of ``_GatherRows``: ``rows`` added into zeros of
    (n, D) at ``ids``, forward through ``ops.embedding_scatter_add`` (a
    row's duplicates in input order, rounding to the rows' dtype after
    every add; no atomics), backward through ``ops.embedding_lookup``."""

    @staticmethod
    def forward(ctx, rows: torch.Tensor, ids: torch.Tensor, n: int):
        ids = ids.reshape(-1).to(torch.int32)
        ctx.save_for_backward(ids)
        out = torch.zeros((n, rows.shape[1]), dtype=rows.dtype,
                          device=rows.device)
        ops.embedding_scatter_add(out, ids, rows)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (ids,) = ctx.saved_tensors
        return ops.embedding_lookup(grad.contiguous(), ids), None, None


def scatter_rows(rows: torch.Tensor, ids: torch.Tensor,
                 n: int) -> torch.Tensor:
    """``out[ids[i]] += rows[i]`` into zeros of (n, D): (N, D) rows, (N,)
    integer ids in ``[0, n)``. Forward through ``embedding_scatter_add``,
    gradient through ``embedding_lookup`` (plain versions on CPU
    tensors)."""
    return _ScatterRows.apply(rows, ids, n)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``: (V, D) table, integer tokens of any shape ->
    tokens.shape + (D,), in the table's dtype, through ``gather_rows``."""
    return gather_rows(table, tokens.reshape(-1)).view(*tokens.shape,
                                                       table.shape[1])


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 with a ``(1 + scale)`` gain, cast back to
    ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary position embedding on dimension halves (GPT-NeoX style).

    x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S).
    The angles are ``positions * theta ** -(arange(half) / half)`` in
    fp32; the rotation runs in fp32 and is cast back to ``x.dtype``.
    """
    half = x.shape[-1] // 2
    freq = torch.arange(half, dtype=torch.float32, device=x.device) / half
    inv_freq = torch.pow(theta, -freq)      # float32, no host-to-device copy
    angles = positions.float()[..., None] * inv_freq          # (..., S, half)
    angles = angles[..., None, :]                             # (..., S, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_init(gen: torch.Generator, shape: tuple[int, ...],
               in_axis_size: int, dtype: torch.dtype) -> torch.Tensor:
    """Scaled-normal initializer (variance 1/fan_in), drawn in fp32 from
    ``gen`` on ``gen``'s device and cast to ``dtype``."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * in_axis_size ** -0.5).to(dtype)
