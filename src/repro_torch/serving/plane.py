"""The serving plane: vectorized pull, lag-bounded replica selection,
version-aware serve cache, micro-batching predict scheduler,
multi-scenario registry — counterpart of the reference's
``serving/plane.py``.

Request path (hot):

    predict(ids, scenario)            — immediate single-request path
    submit(ids) … flush()             — coalesced concurrent load
      └ PredictScheduler: chunk the (coalesced) load into buckets
          └ pull: ONE cache probe over the request's flat ids
              ├ hits  — gathered from the cache arena (on the device
              │         under the torch backend: probe + gather kernels)
              └ misses — unique → argsort ownership segments (RowRouter)
                         → per-segment replica read (ReplicaSet.read:
                           lag-bounded pick + failover) → cache fill
          └ pad rows to the bucket on the device, predict, slice, split

Cache consistency: every replica's ``SlaveShard.on_apply`` publishes the
(group, ids, op) batches the stream applied; ``on_applied`` drops those
ids from every scenario cache whose group subset contains the group.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.weips_ctr import CTRConfig
from repro_torch.core.ps import resolve_device
from repro_torch.core.routing import RoutingPlan
from repro_torch.models import ctr as ctr_model
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.cache import ServeCache
from repro_torch.serving.registry import Scenario, ScenarioRegistry
from repro_torch.serving.router import RowRouter
from repro_torch.serving.scheduler import (AdmissionConfig, DEFAULT_BUCKETS,
                                           PredictScheduler)


class ServingPlane:
    """Serving-side subsystem over a cluster's slave replica sets.

    ``ps_backend="torch"`` keeps each scenario cache's arena on ``device``
    and answers hits with the device probe→gather; ``"numpy"`` is the
    host path. The predict itself always runs on ``device``."""

    def __init__(self, plan: RoutingPlan, replica_sets: list,
                 store_groups: dict[str, int], *,
                 max_replica_lag: Optional[int] = None,
                 cache_rows: int = 1 << 20,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 ps_backend: str = "torch",
                 device="cuda",
                 admission: Optional[AdmissionConfig] = None,
                 clock=None):
        self.plan = plan
        self.replica_sets = replica_sets
        self.store_groups = dict(store_groups)
        self.max_replica_lag = max_replica_lag
        self.cache_rows = cache_rows
        self.buckets = tuple(buckets)
        self.admission = admission
        self.clock = clock or time.perf_counter
        self.ps_backend = ps_backend
        self.device = resolve_device(device)
        self.router = RowRouter(plan)
        self.registry = ScenarioRegistry()
        self.shard_pulled_rows = 0          # rows read from replicas
        self.predict_seconds = 0.0
        self.device_blocks = 0              # pulls answered device-resident

    # ------------------------------------------------------------------
    # scenarios
    # ------------------------------------------------------------------
    def add_scenario(self, cfg: CTRConfig, *,
                     name: Optional[str] = None) -> Scenario:
        """Register a serving scenario: validates its group subset against
        the shared store, builds its predict fn, cache namespace, and
        micro-batching scheduler."""
        groups = ctr_model.groups_for(cfg)
        ctr_model.check_scenario_groups(groups, self.store_groups)
        cache = ServeCache(groups, max_rows=self.cache_rows,
                           backend=self.ps_backend, device=self.device)
        scn = Scenario(
            name=name or cfg.name, cfg=cfg, groups=groups,
            dense_shapes=ctr_model.dense_shapes(cfg),
            predict_raw=ctr_model.predict_fn(cfg),
            predict_block=ctr_model.predict_block_fn(cfg, cache.offsets),
            cache=cache)
        scn.scheduler = PredictScheduler(
            lambda ids, bucket, s=scn: self._run_bucket(s, ids, bucket),
            buckets=self.buckets, admission=self.admission,
            clock=self.clock)
        return self.registry.add(scn)

    def scenario(self, name: Optional[str] = None) -> Scenario:
        return self.registry.get(name)

    # ------------------------------------------------------------------
    # pull path
    # ------------------------------------------------------------------
    def _fetch_block(self, sid: int, ids: np.ndarray,
                     scn: Scenario) -> np.ndarray:
        """Read one owner segment's combined-group block from shard
        ``sid``'s replica set — ONE replica pick (lag-bounded, failover)
        covers every group of the request."""

        def read(rep):
            out = np.empty((len(ids), scn.cache.width), np.float32)
            for g, (lo, hi) in scn.cache.offsets.items():
                out[:, lo:hi] = rep.lookup(g, ids)
            return out

        self.shard_pulled_rows += len(ids)
        return self.replica_sets[sid].read(read,
                                           max_lag=self.max_replica_lag)

    def _pull_miss(self, scn: Scenario, miss_flat: np.ndarray) -> np.ndarray:
        """Pull + cache-fill the miss set; returns the pulled rows
        expanded back to ``miss_flat`` order (duplicates included)."""
        uniq, inverse = np.unique(miss_flat, return_inverse=True)
        pulled, order = self.router.pull_block_sorted(
            uniq, scn.cache.width, self.plan.slave_shard(uniq),
            lambda sid, seg: self._fetch_block(sid, seg, scn))
        scn.cache.fill(uniq.take(order, mode="clip"), pulled)
        rank = np.empty(len(uniq), dtype=np.int64)
        rank[order] = np.arange(len(uniq), dtype=np.int64)
        return pulled.take(rank.take(inverse, mode="clip"),
                           axis=0, mode="clip")

    def pull_request(self, ids: np.ndarray,
                     scenario: Optional[str] = None):
        """Combined-group rows for a request's flat ids, in request order
        (duplicates included). Misses are uniqued, pulled through the
        router in owner segments, and installed in the cache. Under the
        torch backend the block is a DEVICE tensor; under numpy a host
        array."""
        scn = self.registry.get(scenario)
        flat = np.asarray(ids, dtype=np.int64).reshape(-1)
        if self.ps_backend == "torch":
            return self._pull_request_device(scn, flat)
        block, hit = scn.cache.lookup(flat)
        if block is None or not hit.all():
            miss_flat = flat if block is None else flat[~hit]
            expanded = self._pull_miss(scn, miss_flat)
            if block is None:
                block = expanded               # fully cold: no masked copy
            else:
                block[~hit] = expanded
        return block

    def _pull_request_device(self, scn: Scenario,
                             flat: np.ndarray) -> torch.Tensor:
        """Device pull: the cache's probe→gather answers hits as a device
        block and counts misses off the device found mask; misses are
        pulled from replicas host-side, installed in the cache, and
        written over the device block's miss rows — the block never
        round-trips through host memory between pull and predict."""
        block, hit = scn.cache.lookup_device(flat)
        if hit.all():
            self.device_blocks += 1
            return block
        expanded = self._pull_miss(scn, flat if block is None
                                   else flat[~hit])
        rows = torch.from_numpy(expanded).to(self.device)
        if block is None:
            return rows                        # fully cold: one upload
        self.device_blocks += 1
        miss_idx = torch.from_numpy(np.flatnonzero(~hit)).to(self.device)
        block[miss_idx] = rows
        return block

    def serve_rows(self, ids: np.ndarray,
                   scenario: Optional[str] = None) -> dict[str, np.ndarray]:
        """Predictor pull path: ``{group: (B, F, dim)}`` serve rows as
        host arrays."""
        scn = self.registry.get(scenario)
        b, f = np.asarray(ids).shape
        block = self.pull_request(ids, scenario)
        if isinstance(block, torch.Tensor):
            block = block.cpu().numpy()
        return {g: block[:, lo:hi].reshape(b, f, hi - lo)
                for g, (lo, hi) in scn.cache.offsets.items()}

    def serve_dense(self,
                    scenario: Optional[str] = None) -> dict[str, np.ndarray]:
        """Dense bank for predict — memoized by sync version."""
        scn = self.registry.get(scenario)
        if not scn.dense_shapes:
            return {}

        def read(rep):
            return {
                name: scn.dense_cache.get(
                    name, shape, rep.dense_versions.get(name, -1),
                    lambda n=name: rep.dense.get(n))
                for name, shape in scn.dense_shapes.items()}

        return self.replica_sets[0].read(read, max_lag=self.max_replica_lag)

    # ------------------------------------------------------------------
    # predict path
    # ------------------------------------------------------------------
    def _run_bucket(self, scn: Scenario, ids: np.ndarray,
                    bucket: int) -> np.ndarray:
        """Pull the combined-group block for the real examples, pad it
        (not the ids — the cache never sees padding) up to the bucket on
        the device, predict at the bucket shape, slice the padding off."""
        b, f = ids.shape
        with obs_trace.get_tracer().span("serve.bucket", bucket=bucket,
                                         examples=b):
            return self._run_bucket_inner(scn, ids, b, f, bucket)

    def _run_bucket_inner(self, scn: Scenario, ids: np.ndarray, b: int,
                          f: int, bucket: int) -> np.ndarray:
        block = self.pull_request(ids, scn.name)       # (b*f, width)
        dense = self.serve_dense(scn.name)
        if not isinstance(block, torch.Tensor):
            block = torch.from_numpy(block).to(self.device)
        if b < bucket:
            block = torch.cat([block, block.new_zeros(
                ((bucket - b) * f, block.shape[1]))])
        p = scn.predict_block(
            block, {k: torch.from_numpy(v).to(self.device)
                    for k, v in dense.items()})
        return p.cpu().numpy()[:b]

    def predict(self, ids: np.ndarray,
                scenario: Optional[str] = None) -> np.ndarray:
        """Immediate single-request path. Requests admitted via
        ``submit`` are left pending for the next ``flush``."""
        scn = self.registry.get(scenario)
        t0 = self.clock()
        with obs_trace.get_tracer().span("serve.predict",
                                         scenario=scn.name,
                                         examples=len(ids)):
            out = scn.scheduler.run_one(ids)
        self.predict_seconds += self.clock() - t0
        scn.requests += 1
        scn.examples += len(ids)
        return out

    def submit(self, ids: np.ndarray,
               scenario: Optional[str] = None) -> int:
        """Admit a request without running it — concurrent requests queue
        here and execute coalesced on the next ``flush``."""
        return self.registry.get(scenario).scheduler.submit(ids)

    def flush(self, scenario: Optional[str] = None, *,
              budget: Optional[int] = None) -> list:
        """Execute the pending window; ticket-ordered results, ``None``
        for tickets the admission policy shed."""
        scn = self.registry.get(scenario)
        t0 = self.clock()
        with obs_trace.get_tracer().span("serve.flush",
                                         scenario=scn.name):
            out = scn.scheduler.flush(budget=budget)
        self.predict_seconds += self.clock() - t0
        scn.requests += sum(1 for p in out if p is not None)
        scn.examples += sum(len(p) for p in out if p is not None)
        return out

    # ------------------------------------------------------------------
    # invalidation (stream hooks)
    # ------------------------------------------------------------------
    def on_applied(self, group: str, ids: np.ndarray, op: str) -> None:
        """``SlaveShard.on_apply`` hook: drop rewritten rows from every
        cache namespace that reads the group."""
        for scn in self.registry:
            if group in scn.groups:
                scn.cache.invalidate(ids)

    def invalidate_all(self) -> None:
        """Wholesale flush: serving tables were rebuilt outside the
        stream."""
        for scn in self.registry:
            scn.cache.clear()
            scn.dense_cache.clear()

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------
    def _admission_totals(self) -> dict:
        adm = {"offered_requests": 0, "offered_examples": 0,
               "executed_requests": 0, "executed_examples": 0,
               "shed_requests": 0, "shed_examples": 0,
               "shed_depth_requests": 0, "shed_deadline_requests": 0}
        for s in self.registry:
            if s.scheduler is None:
                continue
            for k, v in s.scheduler.adm.as_dict().items():
                adm[k] += v
        return adm

    def _latency_percentiles(self) -> dict:
        from repro_torch.core.monitor import PercentileRing
        return PercentileRing.merged_percentiles(
            [s.scheduler.latency for s in self.registry
             if s.scheduler is not None], (50, 99))

    def register_metrics(self, reg, prefix: str = "serving") -> None:
        """Publish the plane's counters into a
        ``repro_torch.obs.metrics.MetricsRegistry`` under stable dotted
        names; ``metrics()`` is a view over the same counters."""
        from repro_torch.obs.metrics import join
        reg.register(join(prefix, "scenarios"),
                     lambda: {s.name: s.metrics() for s in self.registry})
        reg.register(join(prefix, "admission"), self._admission_totals)
        reg.register(join(prefix, "latency"), self._latency_percentiles)
        reg.register(join(prefix, "shard_pulled_rows"),
                     lambda: self.shard_pulled_rows)
        reg.register(join(prefix, "predict_seconds"),
                     lambda: self.predict_seconds)
        reg.register(join(prefix, "device_blocks"),
                     lambda: self.device_blocks)
        reg.register(join(prefix, "replica_lag_skips"),
                     lambda: sum(rs.lag_skips for rs in self.replica_sets))

    def metrics(self) -> dict:
        return {
            "scenarios": {s.name: s.metrics() for s in self.registry},
            "admission": self._admission_totals(),
            "latency": self._latency_percentiles(),
            "shard_pulled_rows": self.shard_pulled_rows,
            "predict_seconds": self.predict_seconds,
            "device_blocks": self.device_blocks,
            "replica_lag_skips": sum(rs.lag_skips
                                     for rs in self.replica_sets),
        }

    def window_metrics(self) -> dict:
        """Per-window cache counter deltas for every scenario."""
        return {s.name: s.window_metrics() for s in self.registry}
