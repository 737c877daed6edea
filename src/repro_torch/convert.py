"""Carry state across into the port in bulk, outside the sync stream.

``load_lm_params`` carries an LM's parameter tree (the JAX package's
``models.init_params`` output, as NumPy arrays) into the port's tensors;
``load_lm_train_state`` carries a whole LM ``TrainState`` (params,
optimizer slots, step).

The port deploys rows to its serving replicas through its own sync
stream (``core/streaming.py``: Pusher → int8 codec → queue → Scatter).
These two loaders install columnar state as plain NumPy — the columns the
JAX package produces (``SparseTable.snapshot()``'s ``ids``/``w``/``slots``
per group, or ``WeiPSCluster._serve_state()["groups"]``) — routed to the
owning shards with one argsort pass per group:

* ``load_train_state`` — master rows ``(ids, w, {"z": z, "n": n})`` onto
  their owner masters; the sync stream then deploys them.
* ``load_serve_state`` — serve rows straight into every replica of their
  slave shard, plus the dense bank, the way the reference cluster
  rebuilds its replicas from a checkpoint (``WeiPSCluster._load_serve_rows``
  and ``_apply_dense_state``). Tests use it to make both packages serve
  identical state.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ps import resolve_device
from repro_torch.core.routing import RoutingPlan, owner_segments


def _columns(g: str, ids, rows) -> tuple[np.ndarray, np.ndarray]:
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    if ids.ndim != 1 or rows.ndim != 2 or len(rows) != len(ids):
        raise ValueError(f"group {g!r}: ids {ids.shape} and rows "
                         f"{rows.shape} are not (N,) and (N, dim)")
    return ids, rows


def load_train_state(masters: list, plan: RoutingPlan,
                     groups: dict[str, tuple],
                     dense: Optional[dict[str, np.ndarray]] = None) -> None:
    """Install training rows on their owner master shards.

    Args:
      masters: the master shards, indexed by shard id.
      plan: the routing plan that assigns ids to master shards.
      groups: ``{group: (ids int64 (N,), w float32 (N, dim), slots)}``
        with ``slots`` ``{name: float32 (N, dim)}`` naming every optimizer
        slot of the group's tables (FTRL: ``z`` and ``n``); ids unique
        within a group.
      dense: ``{name: ndarray}`` dense tensors, pushed to master 0 (its
        collector, if attached, records them for the stream).

    An empty table takes the probe-free bulk insert; a table holding rows
    takes ensure + write. Touch statistics start at 0.
    """
    for g, (ids, w, slots) in groups.items():
        ids, w = _columns(g, ids, w)
        slots = {k: _columns(g, ids, v)[1] for k, v in slots.items()}
        if not len(ids):
            continue
        for mid, idx in owner_segments(plan.master_shard(ids)):
            t = masters[mid].tables[g]
            if set(slots) != set(t.slot_names):
                raise ValueError(f"group {g!r}: slots {sorted(slots)} do "
                                 f"not match the table's {t.slot_names}")
            seg_ids = ids.take(idx, mode="clip")
            seg_w = w.take(idx, axis=0, mode="clip")
            seg_slots = {k: v.take(idx, axis=0, mode="clip")
                         for k, v in slots.items()}
            if len(t) == 0:
                zero = np.zeros(len(idx), np.int64)
                t.load_rows({"ids": seg_ids, "w": seg_w, "slots": seg_slots,
                             "last_touch": zero, "touch_count": zero})
            else:
                t.write_rows(t.ensure(seg_ids), seg_w, seg_slots)
    for name, value in (dense or {}).items():
        masters[0].push_dense(name, np.asarray(value, np.float32))


def load_serve_state(replica_sets: list, plan: RoutingPlan,
                     groups: dict[str, tuple[np.ndarray, np.ndarray]],
                     dense: Optional[dict[str, np.ndarray]] = None,
                     dense_versions: Optional[dict[str, int]] = None
                     ) -> None:
    """Install serve rows and dense tensors on every replica.

    Args:
      replica_sets: the serving plane's ``ReplicaSet`` list.
      plan: the routing plan that assigns ids to slave shards.
      groups: ``{group: (ids int64 (N,), rows float32 (N, dim))}``, ids
        unique within a group.
      dense: ``{name: ndarray}`` dense tensors (a DNN's MLP), stored
        flattened as the slave stores streamed dense records.
      dense_versions: ``{name: version}``; 0 for names not given.
    """
    replicas = [shard for rs in replica_sets for shard in rs.replicas]
    by_sid: dict[int, list] = {}
    for shard in replicas:
        by_sid.setdefault(shard.shard_id, []).append(shard)
    for g, (ids, rows) in groups.items():
        ids, rows = _columns(g, ids, rows)
        if not len(ids):
            continue
        for sid, idx in owner_segments(plan.slave_shard(ids)):
            seg_ids = ids.take(idx, mode="clip")
            seg_rows = rows.take(idx, axis=0, mode="clip")
            for shard in by_sid.get(sid, ()):
                shard.tables[g].scatter(seg_ids, seg_rows)
    for shard in replicas:
        for name, t in (dense or {}).items():
            shard.dense[name] = np.asarray(t, np.float32).reshape(1, -1)
            shard.dense_versions[name] = (dense_versions or {}).get(name, 0)


def _lm_tensor(a, device: torch.device) -> torch.Tensor:
    """One parameter leaf as a tensor of the same dtype on ``device``. A
    JAX bfloat16 array reaches NumPy as ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses: it goes through float32 (exact for
    bfloat16) and back."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def load_lm_params(cfg: ModelConfig, params: dict, device="cuda") -> dict:
    """The port's parameter dict from the reference's LM parameter tree.

    Args:
      cfg: the model config both trees were built for.
      params: the reference's ``init_params(cfg, key)`` tree (or any tree
        of the same nesting), leaves as NumPy or JAX arrays: ``embed``,
        ``final_norm``, ``segments[i]["pos{j}"]["mixer" | "ffn"][name]``
        stacked on a leading ``repeats`` axis, and ``lm_head`` when the
        head is untied.
      device: where the tensors go (default the card; raises without one).
    Returns the same nesting with tensors of the leaves' dtypes.
    """
    dev = resolve_device(device)
    want = {"embed", "final_norm", "segments"} | (
        set() if cfg.tie_embeddings else {"lm_head"})
    if set(params) != want:
        raise ValueError(f"{cfg.name}: parameter keys {sorted(params)}, "
                         f"want {sorted(want)}")
    embed_shape = tuple(np.shape(params["embed"]))
    if embed_shape != (cfg.padded_vocab, cfg.d_model):
        raise ValueError(f"{cfg.name}: embed {embed_shape}, want "
                         f"{(cfg.padded_vocab, cfg.d_model)}")
    if len(params["segments"]) != len(cfg.segments):
        raise ValueError(f"{cfg.name}: {len(params['segments'])} segments, "
                         f"want {len(cfg.segments)}")

    def convert(tree, repeats):
        if isinstance(tree, dict):
            return {k: convert(v, repeats) for k, v in tree.items()}
        if np.shape(tree)[:1] != (repeats,):
            raise ValueError(f"{cfg.name}: layer leaf of shape "
                             f"{np.shape(tree)} is not stacked on "
                             f"{repeats} repeats")
        return _lm_tensor(tree, dev)

    out = {k: _lm_tensor(params[k], dev) for k in want - {"segments"}}
    out["segments"] = [convert(sp, seg.repeats) for sp, seg in
                       zip(params["segments"], cfg.segments)]
    return out


def load_lm_train_state(cfg: ModelConfig, state, device="cuda"):
    """The port's ``training.TrainState`` from the reference's.

    Args:
      cfg: the model config both states were built for.
      state: the reference's ``TrainState`` (or any object with
        ``params``, ``slots`` and ``step``), leaves as NumPy or JAX
        arrays: ``slots`` has the params' structure with a dict of
        float32 slots (Adam: ``m``, ``v``) where the params have a leaf;
        ``step`` an integer scalar.
      device: where the tensors go (default the card; raises without one).
    Returns the port's ``TrainState``: params via ``load_lm_params``,
    float32 slot tensors, ``step`` as an int.
    """
    from repro_torch.core.tree import map_like
    from repro_torch.training.trainer import TrainState
    dev = resolve_device(device)
    params = load_lm_params(cfg, state.params, dev)

    def slot_dict(p, slots):
        if any(np.shape(v) != tuple(p.shape) for v in slots.values()):
            raise ValueError(f"{cfg.name}: slots {sorted(slots)} do not "
                             f"match a param of shape {tuple(p.shape)}")
        return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
                for k, v in slots.items()}

    slots = map_like(slot_dict, params, state.slots)
    return TrainState(params=params, slots=slots, step=int(state.step))
