"""WeiPSCluster: the full symmetric fusion system for the paper's online-
learning workload — trainer + master PS (training plane), predictor + slave
PS replicas (serving plane), joined by the streaming sync pipeline, with
cold/hot fault tolerance, progressive validation and domino downgrade.
Counterpart of the reference's ``core/cluster.py``.

``ClusterConfig`` adds ``device`` (default ``"cuda"``), and its backends
default to ``ps_backend="torch"`` and ``codec_backend="torch"``: the
masters' fused FTRL pushes, the replicas' and the serve cache's lookups,
the int8 sync codec and the int8 checkpoint codec run the hand-written
kernels on the card. Asking for ``"cuda"`` without a GPU raises.
``device="cpu"`` runs the kernels' plain versions; ``"numpy"`` backends
are the reference's host paths (the training plane's predict and loss
still run on ``device``).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.configs.weips_ctr import CTRConfig
from repro_torch.core.downgrade import (DominoDowngrade,
                                        SmoothedThresholdTrigger,
                                        VersionManager)
from repro_torch.core.fault_tolerance import (BackupPolicy, Checkpoint,
                                              CheckpointStore, ColdBackup,
                                              ReplicaSet, iter_owner_segments,
                                              merge_dense, merge_shard_tables)
from repro_torch.core.feature_filter import FeatureFilter
from repro_torch.core.monitor import PercentileRing
from repro_torch.core.ps import (MasterShard, SlaveShard, SparseTable,
                                 resolve_device)
from repro_torch.core.queue import FileQueue, PartitionedQueue
from repro_torch.core.routing import RoutingPlan
from repro_torch.core.scheduler import ComponentInfo, Scheduler
from repro_torch.core.streaming import Collector, Gatherer, Pusher, Scatter
from repro_torch.core.transform import make_transform
from repro_torch.data.joiner import SampleJoiner
from repro_torch.models import ctr as ctr_model
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.optim import get_optimizer
from repro_torch.serving import RowRouter, ServingPlane
from repro_torch.serving.scheduler import DEFAULT_BUCKETS, AdmissionConfig
from repro_torch.training.pipeline import TRAIN_BUCKETS, TrainPipeline
from repro_torch.training.plane import TrainingPlane
from repro_torch.training.scheduler import TrainScheduler


def _make_optimizer(cfg: CTRConfig):
    if cfg.optimizer == "ftrl":
        return get_optimizer("ftrl", alpha=cfg.ftrl_alpha, beta=cfg.ftrl_beta,
                             l1=cfg.ftrl_l1, l2=cfg.ftrl_l2)
    return get_optimizer(cfg.optimizer, lr=cfg.lr)


@dataclass
class ClusterConfig:
    num_master: int = 4
    num_slave: int = 2           # slave shards (serving partition count)
    num_replicas: int = 2        # hot-backup replicas per slave shard
    num_partitions: int = 8
    queue_dir: Optional[str] = None  # durable FileQueue root; None=in-memory
    gather_mode: str = "realtime"
    gather_threshold: int = 4096
    gather_period: float = 1.0
    codec: str = "identity"      # identity | cast16 | int8
    codec_backend: str = "torch"  # numpy | torch (delta_codec kernels)
    local_ckpt_interval: float = 30.0
    remote_ckpt_interval: float = 600.0
    ckpt_root: Optional[str] = None
    ckpt_incremental: bool = True   # local cadence writes delta checkpoints
    ckpt_compress: str = "none"     # none | int8 (delta_codec row codec)
    downgrade_metric: str = "logloss"
    downgrade_threshold: float = 1.5
    downgrade_window: int = 10
    feature_min_count: int = 1
    feature_ttl_steps: int = 100_000
    ps_backend: str = "torch"    # numpy | torch (device-mirror row engine)
    device: str = "cuda"         # where the torch backends and the
    #                              training/serving math run
    # serving plane
    serve_max_lag: Optional[int] = None   # staleness bound in queue records;
    #                                       laggier replicas are skipped
    serve_cache_rows: int = 1 << 20       # serve-cache arena bound per scenario
    serve_buckets: tuple = DEFAULT_BUCKETS  # predict micro-batch bucket sizes
    serve_max_pending: Optional[int] = None  # admission depth bound in pending
    #                                       predict examples; over it the
    #                                       OLDEST tickets shed
    serve_deadline: Optional[float] = None  # seconds from admit to execution;
    #                                       expired tickets shed at flush
    # training plane
    train_buckets: tuple = TRAIN_BUCKETS  # train micro-batch bucket sizes
    train_max_sync_lag: Optional[int] = None  # backpressure bound: pipelines
    #                                       throttle while Scatter.lag()
    #                                       exceeds this many records
    train_buffer_cap: int = 1 << 16       # per-pipeline sample buffer bound;
    #                                       beyond it the oldest samples shed
    join_window: float = 30.0             # default sample-join window (s)
    seed: int = 0


class WeiPSCluster:
    def __init__(self, model_cfg: CTRConfig,
                 cluster_cfg: Optional[ClusterConfig] = None, *,
                 clock=None):
        self.cfg = model_cfg
        self.ccfg = cluster_cfg or ClusterConfig()
        c = self.ccfg
        self.device = resolve_device(c.device)
        self.clock = clock      # injectable serve-latency clock (tests);
        #                         None = wall clock (time.perf_counter)
        self.plan = RoutingPlan(c.num_master, c.num_slave, c.num_partitions)
        self.groups = ctr_model.groups_for(model_cfg)
        self.optimizer = _make_optimizer(model_cfg)
        self.transform = make_transform(c.codec, self.optimizer,
                                        backend=c.codec_backend,
                                        device=self.device)
        self.scheduler = Scheduler()
        # a queue_dir swaps the in-memory log for the durable file-backed
        # one (same interface) — the stream then survives process death
        self.queue = FileQueue(c.queue_dir, c.num_partitions) \
            if c.queue_dir else PartitionedQueue(c.num_partitions)
        self.filter = FeatureFilter(c.feature_min_count, c.feature_ttl_steps)

        # ---- training plane -------------------------------------------
        self.masters = [MasterShard(i, self.groups, self.optimizer,
                                    backend=c.ps_backend, device=self.device)
                        for i in range(c.num_master)]
        self.collectors = []
        self.gatherers = []
        self.pushers = []
        for mshard in self.masters:
            col = Collector()
            mshard.collector = col
            self.collectors.append(col)
            self.gatherers.append(Gatherer(
                c.gather_mode, threshold=c.gather_threshold,
                period=c.gather_period))
            self.pushers.append(Pusher(mshard, self.queue, self.plan,
                                       self.transform))
            self.scheduler.register(ComponentInfo("master", mshard.shard_id))

        # ---- serving plane ---------------------------------------------
        self.replica_sets: list[ReplicaSet] = []
        self.scatters: list[Scatter] = []
        for sid in range(c.num_slave):
            rs = ReplicaSet([self._new_slave(sid)
                             for _ in range(c.num_replicas)])
            for rid, shard in enumerate(rs.replicas):
                sc = Scatter(shard, self.queue, self.plan)
                self.scatters.append(sc)
                rs.attach_scatter(shard, sc)   # staleness signal for picks
                self.scheduler.register(ComponentInfo("slave", sid, rid))
            self.replica_sets.append(rs)

        # the serving subsystem; its RowRouter is shared with the
        # training-plane pull (see _pull_rows) — the symmetry the paper
        # names
        admission = None
        if c.serve_max_pending is not None or c.serve_deadline is not None:
            admission = AdmissionConfig(max_pending=c.serve_max_pending,
                                        deadline=c.serve_deadline)
        self.serving = ServingPlane(
            self.plan, self.replica_sets, self.groups,
            max_replica_lag=c.serve_max_lag,
            cache_rows=c.serve_cache_rows, buckets=c.serve_buckets,
            ps_backend=c.ps_backend, device=self.device,
            admission=admission, clock=clock)
        self.add_scenario(model_cfg)          # default scenario
        for rs in self.replica_sets:
            for shard in rs.replicas:
                shard.on_apply = self.serving.on_applied

        # ---- training plane ---------------------------------------------
        self.training = TrainingPlane(
            self.plan, self.masters, self.groups, self.optimizer,
            feature_filter=self.filter,
            on_new_groups=self._on_new_train_groups, seed=c.seed,
            device=self.device)
        self.train_scheduler = TrainScheduler(self.training)
        default_scn = self.training.add_scenario(model_cfg)
        self.scheduler.register_train_scenario(
            self.cfg.name, default_scn.name,
            {"model_type": model_cfg.model_type,
             "groups": sorted(default_scn.store_groups)})
        # the default scenario IS the single-model training state (same
        # dict objects — mutations shared)
        self.dense = default_scn.dense
        self.dense_slots = default_scn.dense_slots

        # ---- stability machinery ----------------------------------------
        self.validator = default_scn.validator
        self.store = CheckpointStore(c.ckpt_root)
        self.cold_backup = ColdBackup(
            self.masters, self.store,
            BackupPolicy(c.local_ckpt_interval, c.remote_ckpt_interval,
                         incremental=c.ckpt_incremental,
                         compress=c.ckpt_compress),
            queue=self.queue, rng=random.Random(c.seed),
            codec_backend=c.codec_backend, device=self.device)
        self.versions = VersionManager(self.store)
        self.downgrader = DominoDowngrade(
            SmoothedThresholdTrigger(
                metric=c.downgrade_metric, threshold=c.downgrade_threshold,
                window=c.downgrade_window),
            self.versions, self._hot_switch)

        self._predict = ctr_model.predict_fn(model_cfg)

        # ---- observability ----------------------------------------------
        # one registry of stable dotted metric names over every
        # subsystem's counters; sync_metrics() is a tree view of it
        self.metrics_registry = MetricsRegistry()
        self._register_metrics(self.metrics_registry)

    def _new_slave(self, shard_id: int) -> SlaveShard:
        c = self.ccfg
        return SlaveShard(shard_id, self.groups, backend=c.ps_backend,
                          device=self.device, codec_backend=c.codec_backend)

    # ------------------------------------------------------------------
    # training plane
    # ------------------------------------------------------------------
    @property
    def step(self) -> int:
        return self.training.scenario().step

    def _pull_rows(self, ids: np.ndarray):
        """Gather (B, F, dim) row tensors for every group from masters —
        the training-plane pull, running the SAME argsort ownership pass
        and bulk gather as the serving plane (``RowRouter``)."""
        b, f = ids.shape
        uniq, inverse = RowRouter.unique(ids)
        vals = self.training.pull_unique(self.training.scenario(), uniq)
        return RowRouter.expand(vals, inverse, (b, f)), uniq, inverse

    def train_on_batch(self, ids: np.ndarray, y: np.ndarray,
                       now: float = 0.0,
                       weights: Optional[np.ndarray] = None) -> dict:
        """One online-learning step for the default scenario:
        predict-before-train validation, then the gradient push through
        the PS optimizer (``TrainingPlane.train_batch``)."""
        return self.training.train_batch(
            self.training.scenario(), ids, y, now=now, weights=weights)

    def _on_new_train_groups(self, created: dict[str, int]) -> None:
        """An isolated training scenario added namespaced groups: create
        their serve tables on every slave replica and widen the serving
        plane's store-group view."""
        for rs in self.replica_sets:
            for shard in rs.replicas:
                for g, dim in created.items():
                    shard.add_group(g, dim)
        self.serving.store_groups.update(created)

    def add_train_scenario(self, cfg: CTRConfig, *,
                           name: Optional[str] = None,
                           share_groups: bool = False):
        """Train an additional model scenario off the shared PS (shared
        groups, or namespaced ``<name>/...`` ones), published to the
        coordination registry like serving scenarios are."""
        scn = self.training.add_scenario(cfg, name=name,
                                         share_groups=share_groups)
        self.scheduler.register_train_scenario(
            self.cfg.name, scn.name,
            {"model_type": cfg.model_type,
             "groups": sorted(scn.store_groups),
             "shared": share_groups})
        return scn

    def make_train_pipeline(self, scenario: Optional[str] = None, *,
                            window: Optional[float] = None,
                            emit_on_feedback: bool = False,
                            neg_sample_rate: float = 1.0) -> TrainPipeline:
        """Build the ingest pipeline (join → admit → dedup → bucketed
        train) for a scenario, backpressure-bound to this cluster's sync
        plane, and register it with the train scheduler."""
        c = self.ccfg
        scn = self.training.scenario(scenario)
        joiner = SampleJoiner(
            window=c.join_window if window is None else window,
            emit_on_feedback=emit_on_feedback,
            neg_sample_rate=neg_sample_rate, seed=c.seed)
        return TrainPipeline(
            self.training, scn, joiner, buckets=c.train_buckets,
            lag_fn=self._sync_lag_records,
            max_sync_lag=c.train_max_sync_lag,
            buffer_cap=c.train_buffer_cap)

    def _sync_lag_records(self) -> int:
        """Records produced to the queue but not yet applied by the
        laggiest live serving replica — the backpressure signal."""
        return max((sc.lag() for sc in self.scatters if sc.shard.alive),
                   default=0)

    # ------------------------------------------------------------------
    # sync plane
    # ------------------------------------------------------------------
    def sync_tick(self, now: float, *, scatter: bool = True) -> int:
        n = 0
        for col, gat, push in zip(self.collectors, self.gatherers,
                                  self.pushers):
            gat.offer(col.drain())
            if gat.ready(now):
                n += push.push(gat.flush(now), now)
        if scatter:
            for sc in self.scatters:
                if sc.shard.alive:
                    sc.poll(now=now)
        return n

    def expire_features(self, now: float) -> int:
        """Feature-filter expiry: delete stale rows, stream the deletions."""
        n = 0
        for m in self.masters:
            for group, table in m.tables.items():
                stale = self.filter.expired(table, m.step)
                if len(stale):
                    m.delete_rows(group, stale)
                    n += len(stale)
        return n

    # ------------------------------------------------------------------
    # serving plane
    # ------------------------------------------------------------------
    def serve_rows(self, ids: np.ndarray,
                   scenario: Optional[str] = None) -> dict[str, np.ndarray]:
        """Predictor pull path — the serving subsystem's cache probe, then
        one ownership pass over the misses feeding lag-bounded replica
        reads with failover."""
        return self.serving.serve_rows(ids, scenario)

    def predict(self, ids: np.ndarray,
                scenario: Optional[str] = None) -> np.ndarray:
        """Serving-plane predict through the micro-batching scheduler."""
        return self.serving.predict(ids, scenario)

    def add_scenario(self, cfg: CTRConfig, *,
                     name: Optional[str] = None):
        """Serve an additional model scenario (a group subset of the
        shared PS) with its own predict fn, cache namespace, scheduler and
        metrics; membership is published to the coordination registry."""
        scn = self.serving.add_scenario(cfg, name=name)
        self.scheduler.register_scenario(
            self.cfg.name, scn.name,
            {"model_type": cfg.model_type, "groups": sorted(scn.groups)})
        return scn

    def _serve_dense(self) -> dict[str, np.ndarray]:
        return self.serving.serve_dense()

    # ------------------------------------------------------------------
    # stability plane
    # ------------------------------------------------------------------
    def _ckpt_metrics(self) -> dict:
        return {"logloss": self.validator.smoothed("logloss"),
                "auc": self.validator.smoothed("auc")}

    def maybe_checkpoint(self, now: float) -> Optional[int]:
        v = self.cold_backup.maybe_checkpoint(now,
                                              metrics=self._ckpt_metrics())
        if v is not None:
            self.scheduler.publish_version(self.cfg.name, v)
        return v

    def checkpoint(self, now: float, tier: str = "local") -> int:
        v = self.cold_backup.checkpoint(now, tier=tier,
                                        metrics=self._ckpt_metrics())
        self.scheduler.publish_version(self.cfg.name, v)
        return v

    def _serve_state(self, version: Optional[int] = None) -> dict:
        """Materialize a checkpoint chain into serving-plane rows: per
        group, the merged columnar row set across all master shards with
        ONE serve transform (train state -> inference weights) applied,
        plus the chain's queue offsets and merged dense bank."""
        state = self.cold_backup.materialize(version)
        groups = {}
        for g, rows in merge_shard_tables(state["shard_snaps"]).items():
            serve = self.transform.serve_values(rows["w"], rows["slots"])
            groups[g] = (rows["ids"], serve)
        dense = {"tensors": {}, "slots": {}, "versions": {}}
        for snap in state["shard_snaps"].values():
            merge_dense(dense, snap["dense"])
        return {"groups": groups, "dense": dense,
                "queue_offsets": state["queue_offsets"],
                "version": state["version"]}

    def _load_serve_rows(self, shards: list, ids: np.ndarray,
                         group: str, serve: np.ndarray) -> None:
        """Route serve rows to slave shards with one argsort ownership
        pass."""
        by_sid: dict[int, list] = {}
        for shard in shards:
            by_sid.setdefault(shard.shard_id, []).append(shard)
        for sid, idx in iter_owner_segments(self.plan.slave_shard(ids)):
            reps = by_sid.get(sid, ())
            if not reps:
                continue
            seg_ids = ids.take(idx, mode="clip")
            seg_serve = serve.take(idx, axis=0, mode="clip")
            for shard in reps:
                shard.tables[group].scatter(seg_ids, seg_serve)

    @staticmethod
    def _apply_dense_state(shard: SlaveShard, dense: dict) -> None:
        """Install a materialized dense bank on a serving replica
        (flattened decoded tensors + version counters, so replayed dense
        records older than the restored version LWW-skip)."""
        for name, t in dense["tensors"].items():
            shard.dense[name] = np.asarray(t, np.float32).reshape(1, -1)
            shard.dense_versions[name] = dense["versions"][name]

    def _hot_switch(self, ckpt: Checkpoint) -> None:
        """Downgrade execution: rebuild slave serve state from the
        checkpoint *chain* (full + deltas materialized by the cold-backup
        plane, master-state -> serve transform), then seek every scatter
        to the checkpoint's queue offsets for consistent replay. The
        replaced tables (and their device mirrors) are released; the new
        ones live on the cluster's device."""
        state = self._serve_state(ckpt.version)
        replicas = [shard for rs in self.replica_sets
                    for shard in rs.replicas]
        c = self.ccfg
        for shard in replicas:
            for g, dim in self.groups.items():
                shard.tables[g] = SparseTable(dim, backend=c.ps_backend,
                                              device=self.device)
            shard._applied_seq = {}
            shard.dense = {}
            shard.dense_versions = {}
            self._apply_dense_state(shard, state["dense"])
        for g, (ids, serve) in state["groups"].items():
            if len(ids):
                self._load_serve_rows(replicas, ids, g, serve)
        for sc in self.scatters:
            sc.seek(ckpt.queue_offsets)
        # the rebuild happened outside the stream — every cached serve
        # row and dense tensor is suspect, flush wholesale
        self.serving.invalidate_all()

    def downgrade_check(self, now: float) -> Optional[int]:
        """Domino-downgrade trigger read — fed by the default scenario's
        windowed ``StreamingEvaluator`` (the training plane's
        progressive-validation signal): a distribution shift the trainer
        sees trips the serving rollback."""
        return self.downgrader.maybe_downgrade(
            now, self.training.scenario().evaluator)

    # ------------------------------------------------------------------
    # chaos / recovery controls
    # ------------------------------------------------------------------
    def kill_master(self, shard_id: int) -> None:
        self.masters[shard_id].kill()
        self.scheduler.mark_dead("master", shard_id)

    def recover_master(self, shard_id: int) -> int:
        v = self.cold_backup.recover_shard(self.masters[shard_id])
        # streaming replay: re-push everything this shard owns, so slaves
        # reconverge even for updates lost after the checkpoint
        m = self.masters[shard_id]
        for group, table in m.tables.items():
            ids = table.all_ids()
            if len(ids):
                m.collector.record(group, ids, "upsert")
        return v

    def _bootstrap_replica(self, shard: SlaveShard) -> Optional[dict]:
        """Checkpoint-restore bootstrap for a fresh serving replica
        (§4.2.2): load the latest checkpoint chain, keep only rows this
        shard owns, and return the stored queue offsets — the caller's
        Scatter replays the stream from there (streaming catch-up)."""
        if self.store.latest() is None:
            return None
        state = self._serve_state()
        for g, (ids, serve) in state["groups"].items():
            if len(ids):
                self._load_serve_rows([shard], ids, g, serve)
        self._apply_dense_state(shard, state["dense"])
        return dict(state["queue_offsets"])

    def add_slave_replica(self, shard_id: int) -> SlaveShard:
        """Grow a replica set online: checkpoint-restore + streaming
        catch-up when a checkpoint exists, else a full copy from a healthy
        peer (whose consumer offsets the new Scatter inherits)."""
        rs = self.replica_sets[shard_id]
        shard = self._new_slave(shard_id)
        offsets = rs.add_replica(shard, bootstrap=self._bootstrap_replica)
        if offsets is None:
            # peer-copied state already reflects everything the peer's
            # scatter applied — start the new consumer there, not at 0
            for sc in self.scatters:
                if sc.shard in rs.replicas and sc.shard is not shard \
                        and sc.shard.alive:
                    offsets = sc.offsets()
                    break
        sc = Scatter(shard, self.queue, self.plan, offsets=offsets)
        self.scatters.append(sc)
        rs.attach_scatter(shard, sc)
        shard.on_apply = self.serving.on_applied   # before catch-up: the
        # replayed records invalidate any cached rows they rewrite
        self.scheduler.register(ComponentInfo(
            "slave", shard_id, len(rs.replicas) - 1))
        sc.poll()          # streaming catch-up: ckpt offsets -> queue head
        return shard

    def kill_slave_replica(self, shard_id: int, replica_idx: int) -> None:
        self.replica_sets[shard_id].replicas[replica_idx].kill()
        self.scheduler.mark_dead("slave", shard_id, replica_idx)

    def _device_mirror_metrics(self) -> dict:
        """Aggregate device-mirror upload counters over every table a
        torch path may have mirrored: master training tables, replica
        serve tables, and scenario cache arenas. All zeros (with
        ``tables: 0``) under the numpy backend."""
        agg = {"tables": 0, "syncs": 0, "key_full_uploads": 0,
               "key_incremental_uploads": 0, "key_bytes_uploaded": 0,
               "arena_bytes_uploaded": 0}
        tables = [t for m in self.masters for t in m.tables.values()]
        tables += [t for rs in self.replica_sets for rep in rs.replicas
                   for t in rep.tables.values()]
        tables += [scn.cache.table for scn in self.serving.registry]
        for t in tables:
            mm = t.mirror_metrics()
            if mm is None:
                continue
            agg["tables"] += 1
            for k in ("syncs", "key_full_uploads",
                      "key_incremental_uploads", "key_bytes_uploaded",
                      "arena_bytes_uploaded"):
                agg[k] += mm[k]
        return agg

    def _register_metrics(self, reg) -> None:
        """Wire every subsystem's counters into the cluster's
        ``MetricsRegistry`` at the reference's dotted paths — the
        registry's ``tree`` IS the sync-metrics dict."""
        reg.register("sync_lag_seconds", lambda now: max(
            (now - sc.last_record_time for sc in self.scatters
             if sc.shard.alive), default=0.0))
        # event→deployed staleness (push→scatter→cache-visible) across
        # every live scatter consumer
        reg.register("staleness", lambda: PercentileRing.merged_percentiles(
            [sc.staleness for sc in self.scatters if sc.shard.alive],
            (50, 99)))
        reg.register("sync_lag_records", self._sync_lag_records)
        reg.register("pushed_bytes",
                     lambda: sum(p.pushed_bytes for p in self.pushers))
        reg.register("queue_bytes", lambda: self.queue.produced_bytes)
        reg.register("dedup_ratio", lambda: float(np.mean(
            [g.stats.dedup_ratio for g in self.gatherers])))
        reg.register("replica_failovers",
                     lambda: sum(rs.failovers for rs in self.replica_sets))
        reg.register("replica_lag_skips",
                     lambda: sum(rs.lag_skips for rs in self.replica_sets))
        reg.register("device_mirror", self._device_mirror_metrics)
        self.serving.register_metrics(reg, prefix="serving")
        self.training.register_metrics(reg, prefix="training")

    def sync_metrics(self, now: float) -> dict:
        """Thin view over the metrics registry: the nested dict assembled
        from the providers each subsystem registered."""
        return self.metrics_registry.tree(now)
