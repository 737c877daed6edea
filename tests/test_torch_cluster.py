"""The port's end-to-end ``WeiPSCluster`` against the JAX package's, on
the CPU.

A quickstart-shaped run: FM-FTRL (32 fields, embed 8) over a 2^14
feature space, 4 masters, 2 slave shards x 2 replicas, 8 partitions, the
durable ``FileQueue``, local and remote checkpoint tiers with delta
chains; a ``ClickStream`` of 128 events a tick through each cluster's
``SampleJoiner`` → ``TrainPipeline`` for 30 ticks of 0.2 s, each tick
``train_scheduler.tick`` → ``sync_tick`` → ``maybe_checkpoint`` →
``downgrade_check``; then a flush, warm predicts, a checkpoint, kill →
recover of master 1, ``add_slave_replica(0)``, and a corrupted stream
until the domino downgrade fires. The port runs on ``device="cpu"``
(its ``torch`` backends run the kernels' plain versions; its ``numpy``
backends the host paths), the reference on its NumPy backends.

Exact: trained examples, checkpoint versions, kinds and bases, the sets
of row ids on every master and replica, the tick and version of the
downgrade. Within ``TOL`` (``rtol=1e-5, atol=1e-6``, as in
``test_torch_training.py``: the port's gradients come from autograd,
which rounds differently from ``jax.grad``): master rows, replica rows,
predictions and the progressive-validation logloss. The sync codec is
``identity`` here, so served rows carry the masters' tolerance; the int8
codecs are held bit-equal in ``test_torch_streaming.py`` and
``test_torch_checkpoint.py``."""

import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest

from repro.configs import weips_ctr as ref_cfgs
from repro.core.cluster import ClusterConfig as RefConfig
from repro.core.cluster import WeiPSCluster as RefCluster
from repro.data import ClickStream as RefStream
from repro_torch.configs import weips_ctr as port_cfgs
from repro_torch.core import ClusterConfig, WeiPSCluster
from repro_torch.data import ClickStream
from test_metrics_schema import SNAPSHOT

TOL = dict(rtol=1e-5, atol=1e-6)
MODEL = dict(feature_space=1 << 14, ftrl_l1=0.01, ftrl_alpha=0.2)
CLUSTER = dict(num_master=4, num_slave=2, num_replicas=2, num_partitions=8,
               local_ckpt_interval=1.0, remote_ckpt_interval=4.0,
               join_window=3.0, downgrade_threshold=0.72,
               downgrade_window=3)
STREAM = dict(feature_space=1 << 14, fields=32, zipf_a=1.2,
              signal_scale=0.8, feedback_delay=1.0, seed=0)
EVENTS, TICKS, DT = 128, 30, 0.2
PIPELINE_NAMES = {
    f"training.scenarios.<scenario>.pipeline.{k}" for k in (
        "buffered", "pending_feedback", "throttled_ticks", "shed_examples",
        "joiner.emitted", "joiner.in_flight", "joiner.late_feedback",
        "joiner.fast_emits", "joiner.negatives_dropped",
        "joiner.join_delay.p50", "joiner.join_delay.p99")}


def _canonical(cl):
    scenarios = {s.name for s in cl.serving.registry} | \
        {s.name for s in cl.training.registry}
    return sorted({".".join("<scenario>" if s in scenarios else s
                            for s in name.split("."))
                   for name in cl.metrics_registry.names(1.0)})


class _Pair:
    """The port's cluster and the reference's, each with its own click
    stream from the same seed and its own train pipeline."""

    def __init__(self, tmp_path, backend):
        self.port = WeiPSCluster(
            dataclasses.replace(port_cfgs.FM_FTRL, **MODEL),
            ClusterConfig(**CLUSTER, device="cpu", ps_backend=backend,
                          codec_backend=backend,
                          queue_dir=str(tmp_path / "port_q"),
                          ckpt_root=str(tmp_path / "port_c")))
        self.ref = RefCluster(
            dataclasses.replace(ref_cfgs.FM_FTRL, **MODEL),
            RefConfig(**CLUSTER, queue_dir=str(tmp_path / "ref_q"),
                      ckpt_root=str(tmp_path / "ref_c")))
        self.streams = (ClickStream(**STREAM), RefStream(**STREAM))
        self.pipes = (self.port.make_train_pipeline(),
                      self.ref.make_train_pipeline())
        self.now = 0.0

    @property
    def both(self):
        return (self.port, self.ref)

    def tick(self):
        fired = []
        for cl, pipe, st in zip(self.both, self.pipes, self.streams):
            pipe.ingest(st.events_batch(EVENTS, self.now))
            cl.train_scheduler.tick(self.now)
            cl.sync_tick(self.now)
            cl.maybe_checkpoint(self.now)
            fired.append(cl.downgrade_check(self.now))
        self.now += DT
        return fired


def _sorted_rows(table):
    ids = np.sort(table.all_ids())
    w, slots = table.gather(ids)
    return ids, w, slots


def _close_masters(port, ref):
    for m, rm in zip(port.masters, ref.masters):
        assert m.step == rm.step
        for g in ref.groups:
            ids, w, slots = _sorted_rows(m.tables[g])
            rids, rw, rslots = _sorted_rows(rm.tables[g])
            np.testing.assert_array_equal(ids, rids)
            np.testing.assert_allclose(w, rw, **TOL)
            for k in rslots:
                np.testing.assert_allclose(slots[k], rslots[k], **TOL)


def _close_replicas(port, ref):
    for rs, rrs in zip(port.replica_sets, ref.replica_sets):
        assert len(rs.replicas) == len(rrs.replicas)
        for rep, rrep in zip(rs.replicas, rrs.replicas):
            for g in ref.groups:
                ids = np.sort(rep.tables[g].all_ids())
                np.testing.assert_array_equal(
                    ids, np.sort(rrep.tables[g].all_ids()))
                np.testing.assert_allclose(rep.lookup(g, ids),
                                           rrep.lookup(g, ids), **TOL)


def _same_store(port, ref):
    assert port.store.versions() == ref.store.versions()
    for v in ref.store.versions():
        a, b = port.store.load(v), ref.store.load(v)
        assert (a.kind, a.base, a.tier, a.queue_offsets, a.created_at) == \
            (b.kind, b.base, b.tier, b.queue_offsets, b.created_at)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_cluster_loop_faults_and_downgrade_match_reference(tmp_path,
                                                           backend):
    pair = _Pair(tmp_path, backend)
    port, ref = pair.both
    for _ in range(TICKS):
        assert pair.tick() == [None, None]
    for cl in pair.both:
        cl.train_scheduler.flush(pair.now + 4.0)
        cl.sync_tick(pair.now + 4.0)
    scn, rscn = port.training.scenario(), ref.training.scenario()
    assert scn.stats.examples == rscn.stats.examples > 0
    assert scn.step == rscn.step
    np.testing.assert_allclose(scn.evaluator.smoothed("logloss"),
                               rscn.evaluator.smoothed("logloss"), **TOL)
    _same_store(port, ref)
    kinds = {port.store.load(v).kind for v in port.store.versions()}
    assert kinds == {"full", "delta"}
    _close_masters(port, ref)
    _close_replicas(port, ref)
    ids, _ = pair.streams[0].batch(64)
    rids, _ = pair.streams[1].batch(64)
    np.testing.assert_array_equal(ids, rids)
    for _ in range(2):                           # cold, then warm
        p = port.predict(ids)
        assert p.shape == (64,) and np.isfinite(p).all()
        np.testing.assert_allclose(p, ref.predict(ids), **TOL)
    assert np.ptp(p) > 1e-3                     # weights are not all 0

    # checkpoint → kill → recover master 1 → replica bootstrap
    now = pair.now + 5.0
    assert port.checkpoint(now) == ref.checkpoint(now)
    for cl in pair.both:
        cl.kill_master(1)
    with pytest.raises(RuntimeError, match="down"):
        port.masters[1].pull("v", ids[0])
    assert port.recover_master(1) == ref.recover_master(1)
    assert port.masters[1].alive
    _close_masters(port, ref)
    for cl in pair.both:
        cl.sync_tick(now)
    new = port.add_slave_replica(0)
    ref.add_slave_replica(0)
    assert new.device == port.device and len(port.replica_sets[0].replicas) == 3
    _close_replicas(port, ref)
    np.testing.assert_allclose(port.predict(ids), ref.predict(ids), **TOL)

    # a corrupted stream trips the domino downgrade on the same tick
    for st in pair.streams:
        st.corrupt()
    pair.now = now + DT                         # the clock moves on
    for tick in range(40):
        fired = pair.tick()
        assert fired[0] == fired[1]
        if fired[0] is not None:
            break
    assert fired[0] is not None, "no downgrade within 40 ticks"
    assert port.downgrader.downgrades == ref.downgrader.downgrades
    _same_store(port, ref)
    # right after the hot switch: the replicas hold the chosen
    # checkpoint's serve rows and the serve cache is empty
    state = port._serve_state(fired[0])
    for rs in port.replica_sets:
        for rep in rs.replicas:
            for g, (gids, serve) in state["groups"].items():
                mine = port.plan.slave_shard(gids) == rep.shard_id
                assert len(rep.tables[g]) == int(mine.sum())
                np.testing.assert_array_equal(rep.lookup(g, gids[mine]),
                                              serve[mine])
    assert all(len(s.cache) == 0 for s in port.serving.registry)
    _close_replicas(port, ref)
    for cl in pair.both:
        cl.sync_tick(pair.now)                  # replay from the offsets
    _close_replicas(port, ref)
    np.testing.assert_allclose(port.predict(ids), ref.predict(ids), **TOL)
    # the metrics surface: the frozen names plus the pipeline's
    names = _canonical(port)
    assert names == _canonical(ref)
    assert set(names) == set(SNAPSHOT) | PIPELINE_NAMES


def test_defaults_and_metric_names():
    """``ClusterConfig`` defaults to the card; without a pipeline the
    metric names are exactly the frozen snapshot."""
    cc = ClusterConfig()
    assert (cc.ps_backend, cc.codec_backend, cc.device) == \
        ("torch", "torch", "cuda")
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            WeiPSCluster(port_cfgs.FM_FTRL)
    cl = WeiPSCluster(port_cfgs.FM_FTRL, ClusterConfig(
        num_master=1, num_slave=2, num_replicas=1, num_partitions=2,
        device="cpu"))
    ids = np.arange(64, dtype=np.int64).reshape(2, 32)
    cl.train_on_batch(ids, np.zeros(2, np.float32), now=0.0)
    cl.sync_tick(0.0)
    cl.predict(ids)
    assert _canonical(cl) == sorted(SNAPSHOT)
    assert len(SNAPSHOT) == 63
    assert cl.sync_metrics(2.0) == cl.metrics_registry.tree(2.0)


def test_perfetto_matches_reference(tmp_path):
    """``obs.perfetto`` is the reference's JSON: the same document for
    the same spans, and ``write_trace`` → ``load_spans`` → ``merge_spans``
    round trips."""
    from repro.obs import perfetto as ref_pf
    from repro_torch.obs import perfetto as pf
    spans = [{"name": "sync.push", "proc": "master-0", "trace": 7,
              "span": 1, "parent": 0, "t0": 10.0, "t1": 10.25,
              "args": {"groups": 2}},
             {"name": "sync.apply", "proc": "slave-1", "trace": 7,
              "span": 2, "parent": 1, "t0": 10.5, "t1": 10.75},
             {"name": "mark", "proc": "slave-1", "trace": 0, "span": 3,
              "parent": 0, "t0": 11.0, "t1": None}, None]
    assert pf.to_chrome(spans) == ref_pf.to_chrome(spans)
    assert pf.write_trace(str(tmp_path / "a.json"), spans) == \
        ref_pf.write_trace(str(tmp_path / "b.json"), spans) == 3
    got = pf.load_spans(str(tmp_path / "a.json"))
    assert got == ref_pf.load_spans(str(tmp_path / "b.json"))
    assert [s["name"] for s in got] == ["sync.push", "sync.apply", "mark"]
    assert pf.merge_spans(got, got[:1], None) == \
        ref_pf.merge_spans(got, got[:1], None) == got


def test_trace_viewer_matches_reference(tmp_path, capsys):
    """``python -m repro_torch.obs.trace <dump>`` prints the reference
    viewer's report for the same dump: a tracer's spans exported through
    the port's ``obs.perfetto`` (two traces, a nested span and an
    annotation); a dump with no spans exits 1 in both."""
    import subprocess
    import sys

    from repro.obs import trace as ref_trace
    from repro_torch.obs import perfetto as pf
    from repro_torch.obs import trace as obs_trace
    t = [0.0]

    def clock():
        t[0] += 0.001
        return t[0]

    tracer = obs_trace.Tracer(enabled=True, process="master-0", clock=clock)
    for _ in range(2):
        with tracer.span("sync.push", groups=2):
            with tracer.span("sync.encode"):
                pass
    tracer.instant("fault.kill", target="master-1")
    path = tmp_path / "t.json"
    assert pf.write_trace(str(path), tracer.export()) == 5
    assert obs_trace.main([str(path), "--slowest", "2"]) == 0
    got = capsys.readouterr().out
    assert ref_trace.main([str(path), "--slowest", "2"]) == 0
    assert got == capsys.readouterr().out
    assert "sync.encode" in got and "fault.kill" in got
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.trace",
                          str(path)], cwd=root, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert out.returncode == 0 and "sync.push" in out.stdout
    empty = tmp_path / "empty.json"
    assert pf.write_trace(str(empty), []) == 0
    assert obs_trace.main([str(empty)]) == 1 == ref_trace.main([str(empty)])
