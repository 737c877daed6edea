"""Closed-loop SLO load harness — the counterpart of the reference's
``launch/slo.py``: the driver that exercises the serve and train planes
*concurrently* against one shared PS. ``SLOConfig.device`` is the
cluster's device (the port's torch backends run there: the kernels on
the card, their plain versions on ``"cpu"``).

Every tick of the loop interleaves the full production shape:

    1. deploy   — poll every scatter consumer (updates pushed during the
                  previous tick become cache-visible; event→deployed
                  staleness = poll_now − push-stamped ``meta["t"]``)
    2. offer    — seeded Zipf predict requests per scenario are admitted
                  into the predict scheduler (``submit``), where the
                  admission policy may depth-shed the oldest tickets
    3. serve    — ``flush(budget=...)`` executes up to the service
                  budget; offered load beyond it stays queued, so
                  overload shows up as queue depth → latency → sheds
                  instead of being hidden by an unbounded drain
    4. train    — stream events ingest into the sample joiner; matured
                  feedback joins; full buckets train and push gradients
    5. push     — the sync plane batches the tick's updates into the
                  queue (their scatter waits for the NEXT tick's deploy
                  step, which is what makes staleness non-trivial)

Offered load is expressed as a multiplier of the per-tick service
budget: 0.5x is an underloaded plane (p50 == p99 == service time), 2x+
is sustained overload where the depth bound must convert queue growth
into counted sheds and a *bounded* p99 — the graceful-degradation claim
the reference's benchmark (``benchmarks/e2e_slo.py``) sweeps and the
deterministic tests (``tests/test_torch_slo.py`` here) replay with a
``ManualClock``.

The table is pre-seeded to ``cfg.rows`` serve rows (≥1M in the full
benchmark) so the Zipf head hits a realistic id cardinality, and two
scenarios (the FM store + an LR head sharing its ``w`` group) serve and
train at the same time — multi-scenario contention on one PS, not a
single-model microbenchmark.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

from repro_torch.configs.weips_ctr import FM_FTRL, LR_FTRL
from repro_torch.core.cluster import ClusterConfig, WeiPSCluster
from repro_torch.core.monitor import PercentileRing
from repro_torch.data.streams import ClickStream


@dataclass
class SLOConfig:
    """Knobs for one harness instance (see docs/BENCHMARKS.md)."""

    rows: int = 1 << 20             # pre-seeded serve-table id space
    fields: int = 8                 # feature fields per example
    zipf_a: float = 1.2             # request/traffic skew
    req_batch: int = 128            # examples per predict request
    budget: int = 2048              # serve budget per scenario per tick
    train_events: int = 512         # stream events ingested per tick
    warmup_ticks: int = 4
    measure_ticks: int = 16
    max_pending: Optional[int] = None   # admission depth bound (examples)
    deadline: Optional[float] = None    # admission deadline (seconds)
    feedback_delay: float = 0.005   # exposure→feedback gap (seconds) —
    #                                 sub-tick so clicks mature in wall time
    join_window: float = 0.05       # sample-join window (seconds)
    num_master: int = 2
    num_slave: int = 2
    num_replicas: int = 2
    lr_head: bool = True            # second scenario (LR on the FM store)
    seed: int = 0
    device: str = "cuda"            # the cluster's device


class SLOHarness:
    """One cluster + N scenarios + seeded traffic, driven tick by tick.

    ``clock`` defaults to wall time (``time.perf_counter``); inject a
    :class:`~repro_torch.core.monitor.ManualClock` plus ``tick_dt`` and the
    whole loop — admission stamps, deadline sheds, latency percentiles,
    staleness — replays in exact simulated seconds.
    """

    def __init__(self, cfg: Optional[SLOConfig] = None, *,
                 clock=None, tick_dt: Optional[float] = None):
        self.cfg = cfg or SLOConfig()
        c = self.cfg
        self.clock = clock or time.perf_counter
        self.tick_dt = tick_dt
        # size the model configs to the harness's traffic shape (the
        # presets assume 32 fields / 4M-id space)
        fm = replace(FM_FTRL, fields=c.fields, feature_space=c.rows)
        lr = replace(LR_FTRL, fields=c.fields, feature_space=c.rows)
        self.cluster = WeiPSCluster(fm, ClusterConfig(
            num_master=c.num_master, num_slave=c.num_slave,
            num_replicas=c.num_replicas, join_window=c.join_window,
            serve_max_pending=c.max_pending, serve_deadline=c.deadline,
            seed=c.seed, device=c.device), clock=clock)
        # scenario roster: the FM store itself + an LR head refining the
        # store's own "w" group (serve AND train concurrently)
        self.serve_names = [fm.name]
        # emit-on-feedback: positives train as their click matures (the
        # paper's timeliness point) — without it a wall-clock run this
        # short would never see the join window expire
        self.train_pipes = [(fm.name, self.cluster.make_train_pipeline(
            emit_on_feedback=True))]
        if c.lr_head:
            self.cluster.add_scenario(lr)
            lr_scn = self.cluster.add_train_scenario(lr,
                                                     share_groups=True)
            self.serve_names.append(lr.name)
            self.train_pipes.append(
                (lr_scn.name,
                 self.cluster.make_train_pipeline(
                     lr_scn.name, emit_on_feedback=True)))
        # seeded, independent traffic sources per role
        self.serve_streams = {
            name: ClickStream(feature_space=c.rows, fields=c.fields,
                              zipf_a=c.zipf_a, seed=c.seed + 101 + i)
            for i, name in enumerate(self.serve_names)}
        self.train_streams = {
            name: ClickStream(feature_space=c.rows, fields=c.fields,
                              zipf_a=c.zipf_a,
                              feedback_delay=c.feedback_delay,
                              seed=c.seed + 201 + i)
            for i, (name, _) in enumerate(self.train_pipes)}
        self._preseed()
        self.train_batches = 0

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def _preseed(self) -> None:
        """Install ``cfg.rows`` serve rows on every slave replica (all
        replicas of a shard get identical values — they are supposed to
        be copies) so predicts hit a populated table from tick 0 instead
        of measuring an empty-store cold start."""
        c = self.cfg
        rng = np.random.default_rng(c.seed + 7)
        ids = np.arange(c.rows, dtype=np.int64)
        owner = self.cluster.plan.slave_shard(ids)
        for sid, rs in enumerate(self.cluster.replica_sets):
            owned = ids[owner == sid]
            if not len(owned):
                continue
            for g, dim in self.cluster.groups.items():
                vals = rng.normal(scale=0.05,
                                  size=(len(owned), dim)).astype(np.float32)
                for shard in rs.replicas:
                    shard.tables[g].scatter(owned, vals)

    # ------------------------------------------------------------------
    # drive
    # ------------------------------------------------------------------
    def _advance(self) -> None:
        if self.tick_dt is not None and hasattr(self.clock, "advance"):
            self.clock.advance(self.tick_dt)

    def requests_per_tick(self, multiplier: float) -> int:
        """Offered requests per scenario per tick for a budget multiple."""
        c = self.cfg
        return max(1, int(round(multiplier * c.budget / c.req_batch)))

    def tick(self, multiplier: float = 1.0) -> dict:
        """One closed-loop tick (deploy → offer → serve → train → push).
        Returns the tick's flush results per scenario (``None`` slots are
        shed tickets)."""
        c = self.cfg
        now = self.clock()
        for sc in self.cluster.scatters:            # 1. deploy
            if sc.shard.alive:
                sc.poll(now=now)
        n_req = self.requests_per_tick(multiplier)
        for name, stream in self.serve_streams.items():   # 2. offer
            for _ in range(n_req):
                self.cluster.serving.submit(stream.features(c.req_batch),
                                            scenario=name)
        flushed = {}
        for name in self.serve_names:               # 3. serve
            flushed[name] = self.cluster.serving.flush(name,
                                                       budget=c.budget)
        for name, pipe in self.train_pipes:         # 4. train
            pipe.ingest(self.train_streams[name].events_batch(
                c.train_events, self.clock()))
            self.train_batches += len(pipe.tick(self.clock()))
        self.cluster.sync_tick(self.clock(), scatter=False)   # 5. push
        self._advance()
        return flushed

    # ------------------------------------------------------------------
    # measurement
    # ------------------------------------------------------------------
    def _schedulers(self):
        return [self.cluster.serving.scenario(n).scheduler
                for n in self.serve_names]

    def reset_window(self) -> None:
        """Start a measurement window: clear latency + staleness rings
        and advance every cache's window mark (lifetime counters and
        model state are untouched)."""
        for sched in self._schedulers():
            sched.latency.reset()
        for sc in self.cluster.scatters:
            sc.staleness.reset()
        self.cluster.serving.window_metrics()

    def run_point(self, multiplier: float) -> dict:
        """Warmup, then measure one offered-load point."""
        c = self.cfg
        for _ in range(c.warmup_ticks):
            self.tick(multiplier)
        self.reset_window()
        adm0 = self._adm_totals()
        t0 = time.perf_counter()
        clk0 = self.clock()
        for _ in range(c.measure_ticks):
            self.tick(multiplier)
        wall = time.perf_counter() - t0
        clk = self.clock() - clk0
        adm = {k: v - adm0[k] for k, v in self._adm_totals().items()}
        stale = PercentileRing.merged_percentiles(
            [sc.staleness for sc in self.cluster.scatters
             if sc.shard.alive], (50, 99))
        lat = PercentileRing.merged_percentiles(
            [s.latency for s in self._schedulers()], (50, 99))
        elapsed = wall if self.tick_dt is None else clk
        return {
            "multiplier": multiplier,
            "ticks": c.measure_ticks,
            "requests_per_tick": self.requests_per_tick(multiplier)
            * len(self.serve_names),
            "latency_s": lat,
            "staleness_s": stale,
            "admission": adm,
            "pending_examples": sum(s.pending_examples
                                    for s in self._schedulers()),
            "predict_throughput_eps":
                adm["executed_examples"] / max(elapsed, 1e-9),
            "caches": self.cluster.serving.window_metrics(),
        }

    def _adm_totals(self) -> dict:
        return dict(self.cluster.serving.metrics()["admission"])

    def sweep(self, multipliers=(0.5, 1.0, 2.0, 4.0)) -> list[dict]:
        return [self.run_point(m) for m in multipliers]

    def metrics(self) -> dict:
        out = self.cluster.sync_metrics(self.clock())
        out["train_batches"] = self.train_batches
        out["train_examples"] = sum(
            s["examples"] for s in
            out["training"]["scenarios"].values())
        return out

    def export_trace(self, path: str) -> int:
        """Write the process tracer's span ring (the harness runs every
        plane in-process) as Perfetto JSON. Returns the event count —
        0 means the tracer was never ``configure``d on."""
        from repro_torch.obs import perfetto
        from repro_torch.obs import trace as obs_trace
        return perfetto.write_trace(path, obs_trace.get_tracer().export())
