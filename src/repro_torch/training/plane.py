"""The training plane — the symmetric twin of ``serving/plane.py``;
counterpart of the reference's ``training/plane.py``.

    train_batch(scenario, ids, y, w):
      ONE np.unique over the batch's ids (the ≥90 % update-repetition
      dedup, shared by admission, pull, and push)
        ├ FeatureFilter admission — gates row *creation*: the pull reads
        │   with create=False (absent rows are zeros, exactly what a fresh
        │   row would hold) and non-admitted ids are dropped from the
        │   gradient push
        ├ pull: argsort owner segments (RowRouter — the SAME routing code
        │   the serving plane runs) → bulk master reads (the device probe
        │   → gather under the torch PS backend)
        ├ optional pad to a bucket (padding weight 0)
        ├ progressive validation BEFORE the update (paper §4.3.1), the
        │   predict on ``device``
        └ weighted loss and row/dense gradients with torch.autograd on
            ``device``; per-row grads summed over the batch inverse on the
            host (np.add.at), routed to owner masters, whose FTRL runs
            the fused kernel chain; the dense head updated through the
            shared optimizer and re-broadcast

The routing and the per-row aggregation stay on the host, as in the
reference.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.weips_ctr import CTRConfig
from repro_torch.core.feature_filter import FeatureFilter
from repro_torch.core.ps import resolve_device
from repro_torch.core.routing import RoutingPlan
from repro_torch.models import ctr as ctr_model
from repro_torch.optim import Optimizer
from repro_torch.serving.router import RowRouter
from repro_torch.training.registry import TrainRegistry, TrainScenario


class TrainingPlane:
    """Training-side subsystem over a cluster's master shards. The
    predict and the loss/gradients run on ``device``."""

    def __init__(self, plan: RoutingPlan, masters: list,
                 store_groups: dict[str, int], optimizer: Optimizer, *,
                 feature_filter: Optional[FeatureFilter] = None,
                 on_new_groups: Optional[Callable] = None,
                 seed: int = 0, device="cuda"):
        self.plan = plan
        self.masters = masters
        self.store_groups = store_groups      # live view of the PS groups
        self.optimizer = optimizer
        self.filter = feature_filter
        # cluster hook: create slave tables / widen serving store_groups
        # when an isolated scenario adds namespaced groups
        self.on_new_groups = on_new_groups
        self.seed = seed
        self.device = resolve_device(device)
        self.router = RowRouter(plan)
        self.registry = TrainRegistry()

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    # scenarios
    # ------------------------------------------------------------------
    def add_scenario(self, cfg: CTRConfig, *, name: Optional[str] = None,
                     share_groups: bool = True) -> TrainScenario:
        """Register a training scenario. ``share_groups=True`` trains the
        store's own groups (validated subset; the optimizer family must
        match the store's). ``share_groups=False`` namespaces every group
        (and dense tensor) under ``<name>/`` and creates the tables online
        on every master (and, via ``on_new_groups``, every slave)."""
        name = name or cfg.name
        if cfg.optimizer != getattr(self.optimizer, "name", cfg.optimizer):
            raise ValueError(
                f"scenario optimizer {cfg.optimizer!r} must match the "
                f"store optimizer {self.optimizer.name!r} (one Pusher "
                f"transform per cluster)")
        groups = ctr_model.groups_for(cfg)
        if share_groups:
            ctr_model.check_scenario_groups(groups, self.store_groups)
            group_map = {g: g for g in groups}
            dense_prefix = ""
        else:
            group_map = {g: f"{name}/{g}" for g in groups}
            dense_prefix = f"{name}/"
            created = {}
            for g, dim in groups.items():
                store_g = group_map[g]
                for m in self.masters:
                    m.add_group(store_g, dim)
                self.store_groups[store_g] = dim
                created[store_g] = dim
            if self.on_new_groups is not None:
                self.on_new_groups(created)

        gen = torch.Generator().manual_seed(self.seed + len(self.registry))
        dense = ctr_model.init_dense(cfg, gen)
        dense_slots = {k: self.optimizer.init_slots(self._dev(v))
                       for k, v in dense.items()}
        scn = TrainScenario(
            name=name, cfg=cfg, group_map=group_map, groups=groups,
            predict=ctr_model.predict_fn(cfg),
            loss_grads=ctr_model.weighted_loss_and_grads_fn(cfg),
            dense=dense, dense_slots=dense_slots, dense_prefix=dense_prefix)
        for dn, v in dense.items():
            self.masters[0].push_dense(scn.dense_store_name(dn), v)
        return self.registry.add(scn)

    def scenario(self, name: Optional[str] = None) -> TrainScenario:
        return self.registry.get(name)

    # ------------------------------------------------------------------
    # pull path (the training twin of ServingPlane.pull_request)
    # ------------------------------------------------------------------
    def pull_unique(self, scn: TrainScenario,
                    uniq: np.ndarray) -> dict[str, np.ndarray]:
        """Unique-space ``{model group: (U, dim)}`` training rows through
        the shared argsort ownership router. ``create=False``: a row that
        does not exist yet reads as zeros, so row *creation* stays with
        the gradient push, where admission gates it."""
        return self.router.pull(
            uniq, scn.groups, self.plan.master_shard(uniq),
            lambda mid, mids: {
                g: self.masters[mid].pull(scn.group_map[g], mids,
                                          create=False)
                for g in scn.groups})

    # ------------------------------------------------------------------
    # train step
    # ------------------------------------------------------------------
    def train_batch(self, scn: TrainScenario, ids: np.ndarray,
                    y: np.ndarray, *, now: float = 0.0,
                    weights: Optional[np.ndarray] = None,
                    bucket: Optional[int] = None) -> dict:
        """One online-learning step for one scenario: predict-before-train
        validation, weighted loss, gradient push through the PS
        optimizer. ``bucket`` pads rows/labels/weights up to that example
        count (padding weight 0)."""
        ids = np.asarray(ids, dtype=np.int64)
        b, f = ids.shape
        y = np.asarray(y, np.float32)
        w = np.ones(b, np.float32) if weights is None else \
            np.asarray(weights, np.float32)

        # ONE dedup serves admission, pull, and push
        uniq, inverse = RowRouter.unique(ids)
        scn.stats.raw_ids += ids.size
        scn.stats.unique_ids += len(uniq)
        admitted = self.filter.admit(uniq) if self.filter is not None \
            else uniq

        vals = self.pull_unique(scn, uniq)
        rows = RowRouter.expand(vals, inverse, (b, f))

        nb = b if bucket is None or bucket < b else bucket
        if nb > b:
            pad = nb - b
            rows = {g: np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], v.dtype)]) for g, v
                in rows.items()}
            y_in = np.concatenate([y, np.zeros(pad, np.float32)])
            w_in = np.concatenate([w, np.zeros(pad, np.float32)])
            scn.stats.padded_examples += pad
            scn.stats.bucket_counts[nb] = \
                scn.stats.bucket_counts.get(nb, 0) + 1
        else:
            y_in, w_in = y, w
        rows_t = {k: self._dev(v) for k, v in rows.items()}
        dense_t = {k: self._dev(v) for k, v in scn.dense.items()}

        # progressive validation (predict BEFORE applying the update);
        # padded rows are sliced off — the metrics never see them
        with torch.no_grad():
            p = scn.predict(rows_t, dense_t)[:b].cpu().numpy()
        point = scn.validator.observe(now, scn.step, y, p)
        scn.evaluator.observe(now, scn.step, y, p, weights=w)

        loss, row_grads, dense_grads = scn.loss_grads(
            rows_t, dense_t, self._dev(y_in), self._dev(w_in))

        # aggregate per-row grads over duplicate ids, push to owner
        # masters; non-admitted ids are dropped BEFORE the push, so they
        # never create rows (padding rows carry weight 0 → zero grads,
        # and the [:b] slice drops them from the aggregation entirely)
        if self.filter is not None and len(admitted) != len(uniq):
            keep = np.isin(uniq, admitted, assume_unique=True)
        else:
            keep = None
        by_master = self.plan.split_by_master(
            uniq if keep is None else uniq[keep])
        for group, g in row_grads.items():
            g = g[:b].reshape(-1, g.shape[-1]).cpu().numpy()  # (B*F, dim)
            agg = np.zeros((len(uniq), g.shape[-1]), np.float32)
            np.add.at(agg, inverse, g)
            store_g = scn.group_map[group]
            for mid, mids in by_master.items():
                pos = np.searchsorted(uniq, mids)
                self.masters[mid].push_grad(store_g, mids, agg[pos],
                                            step=scn.step)
        # dense updates (DNN head) on master shard 0
        for dn, g in dense_grads.items():
            new_w, new_slots = self.optimizer.update(
                dense_t[dn], scn.dense_slots[dn], g, scn.step)
            scn.dense[dn] = new_w.cpu().numpy()
            scn.dense_slots[dn] = new_slots
            self.masters[0].push_dense(scn.dense_store_name(dn),
                                       scn.dense[dn])

        scn.step += 1
        scn.stats.batches += 1
        scn.stats.examples += b
        return {"loss": float(loss), **point.values}

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------
    def metrics(self) -> dict:
        return {"scenarios": {s.name: s.metrics() for s in self.registry}}

    def register_metrics(self, reg, prefix: str = "training") -> None:
        """Publish per-scenario training counters into a
        ``repro_torch.obs.metrics.MetricsRegistry`` — same shape as
        ``metrics()``."""
        from repro_torch.obs.metrics import join
        reg.register(join(prefix, "scenarios"),
                     lambda: {s.name: s.metrics() for s in self.registry})
