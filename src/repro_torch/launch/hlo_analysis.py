"""Roofline-term extraction from a counted step — the counterpart of the
reference's ``launch/hlo_analysis.py``.

The reference compiles an SPMD program and parses its HLO text for the
collectives' operand sizes. The port has no HLO: it runs the step op by
op under ``CostMode``, a ``CommDebugMode`` that also counts, for every
op on a device's local shard (DTensor's local ops, never the
``DTensor``-level call and never DTensor's shape propagation), its
FLOPs (``torch.utils.flop_counter``'s registry, where the five LM
kernels register theirs), the bytes it moves (each tensor argument read
and each output written once: no fusion; the kernels' own counts from
``kernels._build.OP_BYTES``; views and allocations move none), its
output bytes (the temporaries, with no liveness reuse) and, for a
collective, its operand and result bytes. So the counts are per device,
as the reference's ``cost_analysis`` of the per-device program is.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import _build

# the reference's five collective names
COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# c10d functional (and DTensor's own) collective ops -> the names above
COLLECTIVE_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}

# ops that move no bytes: metadata, allocation without a write, waits
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "_unsafe_view",
             "wait_tensor", "device", "_local_scalar_dense", "sym_size",
             "sym_stride", "sym_numel", "sym_storage_offset"}


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=dict)      # op -> #calls
    operand_bytes: dict = field(default_factory=dict)
    result_bytes: dict = field(default_factory=dict)

    @property
    def total_operand_bytes(self) -> int:
        return sum(self.operand_bytes.values())

    def as_dict(self) -> dict:
        return {"counts": dict(self.counts),
                "operand_bytes": dict(self.operand_bytes),
                "result_bytes": dict(self.result_bytes),
                "total_operand_bytes": self.total_operand_bytes}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


# the ShardingPropagator methods that run an op on global-shape fake
# tensors to learn an output's shape (their names vary across torch
# versions; those present are wrapped)
_PROPAGATORS = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")


class _Propagating:
    """Wraps DTensor's shape propagation while a ``CostMode`` is active:
    inside it the mode counts nothing."""

    def __init__(self):
        self.depth = 0
        self._saved = {}

    def install(self) -> None:
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        for name in _PROPAGATORS:
            orig = SP.__dict__.get(name)
            if orig is None:
                continue
            self._saved[name] = orig

            def wrapped(*args, _orig=orig, **kwargs):
                self.depth += 1
                try:
                    return _orig(*args, **kwargs)
                finally:
                    self.depth -= 1

            setattr(SP, name, wrapped)

    def uninstall(self) -> None:
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        for name, orig in self._saved.items():
            setattr(SP, name, orig)
        self._saved.clear()


class CostMode(CommDebugMode):
    """Per-device FLOPs, bytes, temporaries, op counts and collectives of
    everything run under it (see the module docstring). ``flops``,
    ``bytes``, ``temp_bytes``: totals; ``op_counts`` and ``flops_by_op``:
    ``Counter``s by op name (``"aten.mm"``); ``collectives``: a
    ``CollectiveStats``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.temp_bytes = 0
        self.op_counts: Counter = Counter()
        self.flops_by_op: Counter = Counter()
        self.collectives = CollectiveStats()
        self._prop = _Propagating()

    def __enter__(self):
        self._prop.install()
        return super().__enter__()

    def __exit__(self, *args):
        self._prop.uninstall()
        return super().__exit__(*args)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._prop.depth or isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if func.namespace == "prim":
            return                          # metadata queries
        name = packet.__name__
        op = packet._qualified_op_name.replace("::", ".")
        self.op_counts[op] += 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if name in COLLECTIVE_NAMES:
            key = COLLECTIVE_NAMES[name]
            c = self.collectives
            c.counts[key] = c.counts.get(key, 0) + 1
            c.operand_bytes[key] = c.operand_bytes.get(key, 0) \
                + _build.nbytes(*ins)
            c.result_bytes[key] = c.result_bytes.get(key, 0) \
                + _build.nbytes(*outs)
            return
        registry = torch.utils.flop_counter.flop_registry
        if packet in registry:
            flops = int(registry[packet](*args, **kwargs, out_val=out))
            self.flops += flops
            self.flops_by_op[op] += flops
        if name in _NO_BYTES or func.is_view:
            return
        if func in _build.OP_BYTES:
            self.bytes += _build.OP_BYTES[func](args, kwargs, out)
        else:
            self.bytes += _build.nbytes(*ins, *outs)
        self.temp_bytes += _build.nbytes(*outs)


def collectives_from_comm_mode(mode: CostMode) -> CollectiveStats:
    """Counts, operand bytes and result bytes a collective, under the
    reference's names, from a ``CostMode``'s record (the counterpart of
    ``parse_collectives`` on HLO text)."""
    c = mode.collectives
    return CollectiveStats(dict(c.counts), dict(c.operand_bytes),
                           dict(c.result_bytes))


def count_ops(mode: CostMode, names: tuple[str, ...]) -> dict[str, int]:
    """Counts of specific ops (``"aten.mm"``, ``"repro_torch.
    flash_attention"``) the mode saw — the counterpart of
    ``count_hlo_ops``."""
    return {n: mode.op_counts[n] for n in names if mode.op_counts[n]}
