"""PartitionSpec generation for params, optimizer slots, caches and
batches, and the DTensor placements they stand for — the counterpart of
the reference's ``models/sharding.py``.

Layout policy (the reference's, entry for entry):
  * FSDP on the ``data`` axis (d_model / vocab rows), TP on ``model``
    (heads, ffn, experts, vocab-for-logits). The ``pod`` axis (multi-pod)
    joins batch sharding only — pure DP across pods.
  * GQA with few KV heads shards head_dim on ``model`` when divisible,
    otherwise replicates the KV projections.
  * Decode KV caches: batch -> data, sequence -> model (flash-decode
    combine); long_500k (batch=1) shards sequence over (data, model).

Where the reference attaches a ``NamedSharding`` and lets XLA's GSPMD
partition the program, the port turns each spec into DTensor placements
on a ``DeviceMesh`` (``placements``) and lets DTensor's op-by-op
sharding propagation redistribute where an op needs it
(``logical_axis_constraint`` is ``with_sharding_constraint``). A spec is
the port's own ``P``, a tuple of one entry a tensor dim: None, an axis
name, or a tuple of axis names (major first), so ``tuple(spec)``
compares with the reference's ``PartitionSpec`` entry by entry.

A tuple entry in the mesh's order (``(data, model)`` on a ``(data,
model)`` mesh) is one ``Shard(dim)`` a mesh dim, which DTensor splits
mesh-major. A tuple against the mesh's order (``(model, data)``, the
tp2d serve embedding) splits the dim model-major: chunk ``m * |data| +
d`` on device ``(d, m)``. ``Shard`` cannot say that, so the earlier
mesh dim takes ``_StridedShard(dim, split_factor=|model|)`` and the
later one ``Shard(dim)`` — the layout of a dim sharded first on the
later axis and then, within each shard, on the earlier one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Union

import torch

from repro_torch.configs.base import (ATTN, CROSS_ATTN, ENC_ATTN, LOCAL_ATTN,
                                      MAMBA, MLP, MOE, NONE, LayerSpec,
                                      ModelConfig, Segment)
from repro_torch.core.tree import map_like

PyTree = Any

DATA, MODEL, POD = "data", "model", "pod"


class _Unconstrained:
    """A spec entry that leaves the dim's sharding as it is (JAX's
    ``PartitionSpec.UNCONSTRAINED``)."""

    def __repr__(self) -> str:
        return "UNCONSTRAINED"


UNCONSTRAINED = _Unconstrained()


class P(tuple):
    """A partition spec: ``P(DATA, None, (DATA, MODEL))`` — one entry a
    tensor dim, each None (replicated), an axis name, a tuple of axis
    names (major first) or ``UNCONSTRAINED``. A tuple of one axis is
    that axis, as JAX's ``PartitionSpec`` normalises it."""

    UNCONSTRAINED = UNCONSTRAINED

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class ShardingOptions:
    """Layout policy knobs (the reference's).

    embed_mode:
      * "fsdp" (baseline): embedding/lm-head P(model, data). The D axis is
        sharded on ``data``, which makes the logits contraction run over
        a sharded dimension.
      * "tp": P(model, None) — vocab-TP with replicated D. Logits compute
        locally as (B/data, S, V/model) blocks.

    fsdp:
      * True (baseline, training): weight D-axes sharded on ``data`` —
        every matmul gathers its weight shard.
      * False (serving plane): weight-stationary TP — no per-step weight
        gathers.

    serve_layout (when fsdp=False), picked by memory fit in
    ``launch/dryrun``:
      * "tp":   weights sharded ``model``-way only.
      * "tp2d": feature axes over (model, data), D never sharded.
    """

    embed_mode: str = "fsdp"
    fsdp: bool = True
    serve_layout: str = "tp"


def _mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` in its order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class MeshInfo:
    """Axis sizes + derived batch sharding axes for a mesh: a
    ``DeviceMesh`` (``mesh`` is then that mesh), or, for abstract use,
    ``{axis name: size}`` in mesh order (``mesh`` is then None)."""

    def __init__(self, mesh, opts: Optional[ShardingOptions] = None):
        if isinstance(mesh, dict):
            self.mesh = None
            self.axes = dict(mesh)
        else:
            self.mesh = mesh
            self.axes = _mesh_axes(mesh)
        self.opts = opts or ShardingOptions()
        self.data = self.axes.get(DATA, 1)
        self.model = self.axes.get(MODEL, 1)
        self.batch_axes = ((POD, DATA) if POD in self.axes else (DATA,))

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.axes)

    @property
    def size(self) -> int:
        """Devices in the mesh (the reference's ``mesh.devices.size``)."""
        n = 1
        for v in self.axes.values():
            n *= v
        return n

    def div(self, n: int, axis: str) -> bool:
        return n % self.axes.get(axis, 1) == 0


def _attn_specs(cfg: ModelConfig, m: MeshInfo) -> dict:
    h, g, e = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q_ax = (1, MODEL) if m.div(h, MODEL) else (
        (2, MODEL) if m.div(e, MODEL) else None)
    kv_ax = (1, MODEL) if m.div(g, MODEL) else (
        (2, MODEL) if m.div(e, MODEL) else None)
    if cfg.context_parallel_attn:
        # sequence-sharded attention: projections keep FSDP only; sharding
        # head_dim on `model` would force full-score all-reduces.
        if not m.div(h, MODEL):
            q_ax = None
        if not m.div(g, MODEL):
            kv_ax = None

    if not m.opts.fsdp and m.opts.serve_layout == "tp2d":
        # serving (weight-stationary 2D TP): never shard the contraction
        # dim D; spread heads on `model` and head_dim on `data` when they
        # divide — weights stay resident, decode psums are (B,1,·)-sized.
        def serve_proj(n_heads):
            ax_h = MODEL if m.div(n_heads, MODEL) else None
            ax_e = DATA if (ax_h and m.div(e, DATA)) else (
                MODEL if (not ax_h and m.div(e, MODEL)) else None)
            return P(None, ax_h, ax_e)

        qp, kvp = serve_proj(h), serve_proj(g)
        specs = {
            "norm": P(None),
            "wq": qp, "wk": kvp, "wv": kvp,
            "wo": P(qp[1], qp[2], None),
        }
        if cfg.qkv_bias:
            specs["bq"] = P(qp[1], qp[2])
            specs["bk"] = P(kvp[1], kvp[2])
            specs["bv"] = P(kvp[1], kvp[2])
        return specs

    def proj(base_len, ax, d_axis_pos):
        spec = [None] * base_len
        spec[d_axis_pos] = DATA
        if ax is not None:
            spec[ax[0]] = ax[1]
        return P(*spec)

    specs = {
        "norm": P(None),
        "wq": proj(3, q_ax, 0),                     # (D,H,hd)
        "wk": proj(3, kv_ax, 0),                    # (D,Kv,hd)
        "wv": proj(3, kv_ax, 0),
        # wo (H,hd,D): mirror the q sharding, D -> data
        "wo": P(MODEL if (q_ax and q_ax[0] == 1) else None,
                MODEL if (q_ax and q_ax[0] == 2) else None, DATA),
    }
    if cfg.qkv_bias:
        specs["bq"] = P(MODEL if (q_ax and q_ax[0] == 1) else None,
                        MODEL if (q_ax and q_ax[0] == 2) else None)
        kv_b = P(MODEL if (kv_ax and kv_ax[0] == 1) else None,
                 MODEL if (kv_ax and kv_ax[0] == 2) else None)
        specs["bk"] = kv_b
        specs["bv"] = kv_b
    return specs


def _mlp_specs(cfg: ModelConfig, m: MeshInfo) -> dict:
    if not m.opts.fsdp and m.opts.serve_layout == "tp2d":
        # serving: F over (model, data) = full 2D TP, D unsharded; the
        # w_down psum is (B,1,D)-sized at decode.
        f2d = cfg.d_ff % (m.data * m.model) == 0
        ax = (MODEL, DATA) if f2d else MODEL
        return {
            "norm": P(None),
            "w_gate": P(None, ax),
            "w_up": P(None, ax),
            "w_down": P(ax, None),
        }
    return {
        "norm": P(None),
        "w_gate": P(DATA, MODEL),
        "w_up": P(DATA, MODEL),
        "w_down": P(MODEL, DATA),
    }


def _moe_specs(cfg: ModelConfig, m: MeshInfo) -> dict:
    if not m.opts.fsdp and m.opts.serve_layout == "tp2d":
        # serving: experts on `model`, expert-ffn on `data`, D unsharded.
        e_ax = MODEL if m.div(cfg.num_experts, MODEL) else None
        f_ax = DATA if m.div(cfg.d_ff, DATA) else (
            None if e_ax else MODEL)
        return {
            "norm": P(None),
            "router": P(None, None),
            "w_gate": P(e_ax, None, f_ax),
            "w_up": P(e_ax, None, f_ax),
            "w_down": P(e_ax, f_ax, None),
        }
    if m.div(cfg.num_experts, MODEL):
        up, down = P(MODEL, DATA, None), P(MODEL, None, DATA)
    else:
        up, down = P(None, DATA, MODEL), P(None, MODEL, DATA)
    return {
        "norm": P(None),
        "router": P(DATA, None),
        "w_gate": up,
        "w_up": up,
        "w_down": down,
    }


def _mamba_specs(cfg: ModelConfig, m: MeshInfo) -> dict:
    if not m.opts.fsdp and m.opts.serve_layout == "tp2d":
        di2d = cfg.d_inner % (m.data * m.model) == 0
        ax = (MODEL, DATA) if di2d else MODEL
        return {
            "norm": P(None),
            "wz": P(None, ax),
            "wx": P(None, ax),
            "wB": P(None, None),
            "wC": P(None, None),
            "wdt": P(None, None),
            "conv_w": P(None, None),
            "conv_b": P(None),
            "A_log": P(None),
            "D": P(None),
            "dt_bias": P(None),
            "gnorm": P(ax),
            "out_proj": P(ax, None),
        }
    return {
        "norm": P(None),
        "wz": P(DATA, MODEL),
        "wx": P(DATA, MODEL),
        "wB": P(DATA, None),
        "wC": P(DATA, None),
        "wdt": P(DATA, None),
        "conv_w": P(None, None),
        "conv_b": P(None),
        "A_log": P(None),
        "D": P(None),
        "dt_bias": P(None),
        "gnorm": P(None),
        "out_proj": P(MODEL, DATA),
    }


_MIXER_SPECS = {ATTN: _attn_specs, LOCAL_ATTN: _attn_specs,
                ENC_ATTN: _attn_specs, CROSS_ATTN: _attn_specs,
                MAMBA: _mamba_specs}
_FFN_SPECS = {MLP: _mlp_specs, MOE: _moe_specs}


def _stack(spec_tree: PyTree) -> PyTree:
    """Prepend a None (the repeats axis) to every PartitionSpec."""
    return map_like(lambda s: P(None, *s), spec_tree)


def _segment_specs(seg: Segment, cfg: ModelConfig, m: MeshInfo) -> dict:
    out = {}
    for i, spec in enumerate(seg.pattern):
        layer = {"mixer": _MIXER_SPECS[spec.mixer](cfg, m)}
        if spec.ffn != NONE:
            layer["ffn"] = _FFN_SPECS[spec.ffn](cfg, m)
        out[f"pos{i}"] = _stack(layer)
    return out


def _strip_axis(spec_tree: PyTree, axis: str) -> PyTree:
    """Replace ``axis`` with None in every PartitionSpec of the tree."""
    def fix(p: P) -> P:
        return P(*[None if ax == axis else ax for ax in p])
    return map_like(fix, spec_tree)


def param_pspecs(cfg: ModelConfig, m: MeshInfo) -> PyTree:
    """PartitionSpec tree mirroring ``init_params`` output."""
    if not m.opts.fsdp:
        # serving: vocab sharding only, D unsharded — no gather on the
        # lookup/logit paths (2D = 256-way for the big-model layout).
        embed = (P((MODEL, DATA), None) if m.opts.serve_layout == "tp2d"
                 else P(MODEL, None))
    elif m.opts.embed_mode == "fsdp":
        embed = P(MODEL, DATA)
    else:
        embed = P(MODEL, None)
    specs: dict = {
        "embed": embed,
        "final_norm": P(None),
        "segments": [_segment_specs(s, cfg, m) for s in cfg.segments],
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = embed
    if cfg.encoder_segments:
        specs["encoder"] = {
            "segments": [_segment_specs(s, cfg, m)
                         for s in cfg.encoder_segments],
            "final_norm": P(None),
        }
    if not m.opts.fsdp and m.opts.serve_layout == "tp":
        # pure TP-16 serving: train layout minus the FSDP data axis
        specs = _strip_axis(specs, DATA)
    return specs


def cache_pspecs(cfg: ModelConfig, m: MeshInfo, batch: int,
                 kv_quant: bool = False) -> PyTree:
    """PartitionSpec tree mirroring ``init_cache`` output.

    batch >= data-axis size: batch -> data, seq -> model.
    batch == 1 (long-context): seq -> (data, model).
    """
    shard_seq_wide = batch < m.data

    def kv_spec(seq_len_small: bool):
        # (R, B, S, Kv, hd) — scale entries share the leading axes
        if shard_seq_wide:
            return P(None, None, (DATA, MODEL), None, None)
        if seq_len_small:
            return P(None, DATA, None, None, None)
        return P(None, DATA, MODEL, None, None)

    def kv_entry(s):
        if not kv_quant:
            return {"k": s, "v": s}
        return {"k": s, "v": s, "k_scale": s, "v_scale": s}

    def layer_cache(spec: LayerSpec):
        if spec.mixer == ATTN:
            return kv_entry(kv_spec(False))
        if spec.mixer == LOCAL_ATTN:
            return kv_entry(kv_spec(True))          # ring buffer of size W
        if spec.mixer == CROSS_ATTN:
            s = kv_spec(True)
            return {"xk": s, "xv": s}
        if spec.mixer == MAMBA:
            b_ax = None if shard_seq_wide else DATA
            h_ax = MODEL if m.div(cfg.ssm_num_heads, MODEL) else None
            return {
                "conv": P(None, b_ax, None, None),
                "state": P(None, b_ax, h_ax, None, None),
            }
        raise ValueError(spec.mixer)

    return {
        "segments": [
            {f"pos{i}": layer_cache(spec)
             for i, spec in enumerate(seg.pattern)}
            for seg in cfg.segments
        ],
    }


def batch_pspecs(cfg: ModelConfig, m: MeshInfo, kind: str,
                 global_batch: int) -> dict:
    """Input shardings for train/prefill batches or decode requests."""
    b_ax = m.batch_axes if global_batch >= m.data else None
    out = {"tokens": P(b_ax, None)}
    if cfg.has_encoder_context:
        out["enc_context"] = P(b_ax, None, None)
    if kind == "decode":
        out["pos"] = P(b_ax)
    return out


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: P, mesh: Union["MeshInfo", Any]) -> tuple:
    """The DTensor placements (one a mesh dim) a spec stands for on
    ``mesh`` (a ``DeviceMesh`` or a ``MeshInfo``; only its axis names
    and sizes are read). ``UNCONSTRAINED`` entries place nothing (the
    caller keeps the dim's current sharding), and an axis of size 1
    splits nothing: it is ``Replicate``. Raises ``ValueError`` for
    an axis the mesh lacks, an axis used twice, or a tuple of three or
    more axes against the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    axes = mesh.axes if isinstance(mesh, MeshInfo) else _mesh_axes(mesh)
    names, sizes = list(axes), list(axes.values())
    out: list = [Replicate()] * len(names)
    used: set = set()
    for dim, entry in enumerate(spec):
        if entry is None or entry is UNCONSTRAINED:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx = []
        for ax in group:
            if ax not in axes:
                raise ValueError(f"axis {ax!r} of {spec} is not in the "
                                 f"mesh {tuple(names)}")
            if ax in used:
                raise ValueError(f"axis {ax!r} used twice in {spec}")
            used.add(ax)
            idx.append(names.index(ax))
        idx = [i for i in idx if sizes[i] > 1]
        if idx == sorted(idx):
            for i in idx:
                out[i] = Shard(dim)
        elif len(idx) == 2:
            major, minor = idx          # minor comes first in the mesh
            out[minor] = _StridedShard(dim, split_factor=sizes[major])
            out[major] = Shard(dim)
        else:
            raise ValueError(f"{spec}: a tuple of {len(idx)} axes against "
                             f"the mesh's order {tuple(names)}")
    return tuple(out)


def local_shape(shape: tuple, spec: P, m: MeshInfo) -> tuple[int, ...]:
    """The shape of device 0's shard of a ``shape`` tensor laid out by
    ``spec``: each dim ceil-divided by the product of its axes' sizes
    (the shard every device holds when the sizes divide)."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is None or entry is UNCONSTRAINED:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            out[dim] = -(-out[dim] // m.axes[ax])
    return tuple(out)


def logical_axis_constraint(x: torch.Tensor, m: Optional[MeshInfo],
                            spec: P) -> torch.Tensor:
    """``x`` laid out as ``spec`` on ``m``'s mesh: a ``DTensor`` is
    redistributed (differentiably; DTensor issues and counts the
    collectives), a plain tensor — or any tensor with ``m`` None — is
    returned as it is. A mesh dim an ``UNCONSTRAINED`` entry keeps
    sharding stays as it is."""
    if m is None or m.mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    target = list(placements(spec, m.mesh))
    free = {d for d, e in enumerate(spec) if e is UNCONSTRAINED}
    for i, (want, have) in enumerate(zip(target, x.placements)):
        if (isinstance(want, Replicate) and isinstance(have, Shard)
                and have.dim in free):
            target[i] = have
    if tuple(target) == tuple(x.placements):
        return x
    return x.redistribute(m.mesh, target)
