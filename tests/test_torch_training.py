"""The port's train leg against the JAX package's, on the CPU.

* ``MasterShard.apply_batch`` on the fused route (``torch`` backend on
  ``device="cpu"``: probe → gather → FTRL → scatter through the kernels'
  plain versions) is bit-equal to the reference's ``numpy`` master over
  several steps with duplicate and unsorted ids, and counts the same
  fused batches and device-mirror uploads as its ``pallas`` master.
* One ``TrainingPlane.train_batch`` gives the loss and the per-row
  gradient pushes of the reference's plane within ``rtol=1e-5,
  atol=1e-6``: the gradients come from ``torch.autograd`` instead of
  ``jax.value_and_grad``, which round differently in fp32.
* The whole small loop (train → int8 sync → serve) against a
  ``WeiPSCluster`` on its Pallas PS and codec backends.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import weips_ctr as ref_cfgs
from repro.core.cluster import ClusterConfig, WeiPSCluster
from repro.core.feature_filter import FeatureFilter as RefFilter
from repro.core.monitor import StreamingEvaluator as RefEvaluator
from repro.core.monitor import auc as ref_auc
from repro.core.ps import MasterShard as RefMaster
from repro.core.routing import RoutingPlan as RefPlan
from repro.models import ctr as ref_ctr
from repro.optim import get_optimizer as ref_get_optimizer
from repro.training.plane import TrainingPlane as RefPlane
from repro_torch.configs import weips_ctr as port_cfgs
from repro_torch.convert import load_train_state
from repro_torch.core import streaming as port_st
from repro_torch.core.fault_tolerance import ReplicaSet
from repro_torch.core.feature_filter import FeatureFilter
from repro_torch.core.monitor import StreamingEvaluator, auc
from repro_torch.core.ps import MasterShard, SlaveShard, SparseTable
from repro_torch.core.queue import PartitionedQueue
from repro_torch.core.routing import RoutingPlan
from repro_torch.core.transform import make_transform
from repro_torch.models import ctr as port_ctr
from repro_torch.optim import get_optimizer
from repro_torch.serving import ServingPlane
from repro_torch.training import TrainingPlane

FTRL_KW = dict(alpha=0.1, beta=1.0, l1=0.5, l2=0.2)
TOL = dict(rtol=1e-5, atol=1e-6)


def _ids(rng, n):
    return rng.choice(1 << 40, size=n, replace=False).astype(np.int64)


def _rows_of(table, ids):
    w, slots = table.gather(np.sort(ids))
    return w, slots["z"], slots["n"]


def test_master_fused_route_matches_reference():
    rng = np.random.default_rng(0)
    groups = {"w": 1, "v": 8}
    port = MasterShard(0, groups, get_optimizer("ftrl", **FTRL_KW),
                       backend="torch", device="cpu")
    refs = {b: RefMaster(0, groups, ref_get_optimizer("ftrl", **FTRL_KW),
                         backend=b) for b in ("numpy", "pallas")}
    pool = _ids(rng, 30)
    for step in range(4):
        for g, dim in groups.items():
            ids = pool[rng.integers(0, len(pool), size=24)]   # dup, unsorted
            grads = rng.normal(size=(24, dim)).astype(np.float32)
            for m in (port, *refs.values()):
                assert np.array_equal(m.apply_batch(g, ids, grads,
                                                    step=step),
                                      np.unique(ids))
    assert port.fused_batches == refs["pallas"].fused_batches == 8
    assert refs["numpy"].fused_batches == 0
    assert port.step == refs["numpy"].step == 4
    for g in groups:        # before the reads below, which sync the mirror
        assert port.tables[g].mirror_metrics() == \
            refs["pallas"].tables[g].mirror_metrics()
    for g in groups:
        t, rt = port.tables[g], refs["numpy"].tables[g]
        live = rt.all_ids()
        for a, b in zip(_rows_of(t, live), _rows_of(rt, live)):
            np.testing.assert_array_equal(a, b)
        sl, rsl = t.lookup(np.sort(live)), rt.lookup(np.sort(live))
        np.testing.assert_array_equal(t.touch_count[sl],
                                      rt.touch_count[rsl])
    port.kill()
    with pytest.raises(RuntimeError):
        port.apply_batch("w", pool[:2], np.zeros((2, 1), np.float32))


def test_fused_update_on_absent_id_raises_and_resyncs():
    """An id missing from the map raises ``RuntimeError`` (never
    ``assert``); the mirror's arenas are dropped, so the next read
    re-uploads the host rows the chain did not touch."""
    rng = np.random.default_rng(1)
    t = SparseTable(4, ("n", "z"), backend="torch", device="cpu")
    ids = np.sort(_ids(rng, 8))
    sl = t.ensure(ids)
    before = t.gather(ids)[1]["z"].copy()
    with pytest.raises(RuntimeError, match="absent"):
        t.fused_ftrl_update(np.array([ids[0], 12345], np.int64),
                            np.array([sl[0], 0]), np.ones((2, 4), np.float32),
                            alpha=0.1, beta=1.0, l1=0.5, l2=0.2)
    np.testing.assert_array_equal(t.gather(ids)[1]["z"], before)


def _load_both(rng, groups, plan_args, port_masters, ref_masters):
    """Seeded (w, z, n) rows on both packages' masters."""
    pool = _ids(rng, 50)
    ref_plan = RefPlan(*plan_args)
    opt = ref_get_optimizer("ftrl", **FTRL_KW)
    state = {}
    for g, dim in groups.items():
        z = (rng.normal(size=(50, dim)) * 1.5).astype(np.float32)
        n = rng.uniform(0, 4, size=(50, dim)).astype(np.float32)
        state[g] = (pool, opt._np_weights(z, n), {"z": z, "n": n})
    load_train_state(port_masters, RoutingPlan(*plan_args), state)
    for g, (ids, w, slots) in state.items():
        owner = ref_plan.master_shard(ids)
        for mid, m in enumerate(ref_masters):
            k = owner == mid
            m.load_table_rows(g, {
                "ids": ids[k], "w": w[k],
                "slots": {s: v[k] for s, v in slots.items()},
                "last_touch": np.zeros(k.sum(), np.int64),
                "touch_count": np.zeros(k.sum(), np.int64)})
    return pool


def _record_pushes(masters, log):
    for mid, m in enumerate(masters):
        def push(group, ids, grads, *, step=None, m=m, mid=mid,
                 real=m.push_grad):
            log.append((mid, group, np.array(ids), np.array(grads), step))
            real(group, ids, grads, step=step)
        m.push_grad = push


@pytest.mark.parametrize("model", ["weips-fm-ftrl", "weips-lr-ftrl"])
def test_train_batch_matches_reference(model):
    rng = np.random.default_rng(2)
    fields, plan_args = 4, (2, 2, 4)
    ref_cfg = dataclasses.replace(ref_cfgs.CTR_CONFIGS[model], fields=fields)
    port_cfg = dataclasses.replace(port_cfgs.CTR_CONFIGS[model],
                                   fields=fields)
    groups = ref_ctr.groups_for(ref_cfg)
    port_masters = [MasterShard(i, groups, get_optimizer("ftrl", **FTRL_KW),
                                backend="torch", device="cpu")
                    for i in range(2)]
    ref_masters = [RefMaster(i, groups, ref_get_optimizer("ftrl", **FTRL_KW))
                   for i in range(2)]
    pool = _load_both(rng, groups, plan_args, port_masters, ref_masters)
    port = TrainingPlane(RoutingPlan(*plan_args), port_masters, dict(groups),
                         get_optimizer("ftrl", **FTRL_KW), device="cpu")
    ref = RefPlane(RefPlan(*plan_args), ref_masters, dict(groups),
                   ref_get_optimizer("ftrl", **FTRL_KW))
    port_scn, ref_scn = port.add_scenario(port_cfg), ref.add_scenario(ref_cfg)
    logs = ([], [])
    _record_pushes(port_masters, logs[0])
    _record_pushes(ref_masters, logs[1])

    ids = pool[rng.integers(0, len(pool), size=(16, fields))]
    y = (rng.uniform(size=16) < 0.4).astype(np.float32)
    got = port.train_batch(port_scn, ids, y, now=1.0)
    want = ref.train_batch(ref_scn, ids, y, now=1.0)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    assert len(logs[0]) == len(logs[1]) == 2 * len(groups)
    for (pm, pg, pids, pgr, pst), (rm, rg, rids, rgr, rst) in zip(*logs):
        assert (pm, pg, pst) == (rm, rg, rst)
        np.testing.assert_array_equal(pids, rids)
        np.testing.assert_allclose(pgr, rgr, **TOL)
    assert port_scn.stats.dedup_ratio == ref_scn.stats.dedup_ratio
    assert port_scn.step == ref_scn.step == 1
    assert port.metrics()["scenarios"][port_scn.name]["batches"] == 1
    assert all(m.fused_batches == len(groups) for m in port_masters)


@pytest.mark.parametrize("model", ["weips-lr-ftrl", "weips-fm-ftrl",
                                   "weips-dnn-adam"])
def test_loss_and_grads_match_reference(model):
    """Loss, row and dense gradients of both loss functions, the dense
    tensors carried across (the two frameworks draw other random
    numbers); the first batch has all-zero rows, where every logit is 0
    and ``jnp.maximum`` splits its gradient half and half."""
    cfg = dataclasses.replace(ref_cfgs.CTR_CONFIGS[model], fields=4,
                              dnn_hidden=(8, 4))
    pcfg = dataclasses.replace(port_cfgs.CTR_CONFIGS[model], fields=4,
                               dnn_hidden=(8, 4))
    rng = np.random.default_rng(3)
    dense = port_ctr.init_dense(pcfg, torch.Generator().manual_seed(0))
    ref_dense = ref_ctr.init_dense(cfg, __import__("jax").random.PRNGKey(0))
    assert {k: v.shape for k, v in dense.items()} == \
        {k: v.shape for k, v in ref_dense.items()}
    for k in dense:
        if k.startswith("mlp/b"):
            np.testing.assert_array_equal(dense[k], ref_dense[k])
    y = (rng.uniform(size=12) < 0.5).astype(np.float32)
    w = rng.uniform(0, 2, size=12).astype(np.float32)
    for zero in (True, False):
        rows = {g: (np.zeros((12, 4, d), np.float32) if zero else
                    rng.normal(size=(12, 4, d)).astype(np.float32) * 0.3)
                for g, d in ref_ctr.groups_for(cfg).items()}
        j = ({k: jnp.asarray(v) for k, v in rows.items()},
             {k: jnp.asarray(v) for k, v in dense.items()})
        t = ({k: torch.from_numpy(v) for k, v in rows.items()},
             {k: torch.from_numpy(v) for k, v in dense.items()})
        pairs = [(ref_ctr.loss_and_grads_fn(cfg)(*j, jnp.asarray(y)),
                  port_ctr.loss_and_grads_fn(pcfg)(*t, torch.from_numpy(y))),
                 (ref_ctr.weighted_loss_and_grads_fn(cfg)(
                     *j, jnp.asarray(y), jnp.asarray(w)),
                  port_ctr.weighted_loss_and_grads_fn(pcfg)(
                      *t, torch.from_numpy(y), torch.from_numpy(w)))]
        for want, got in pairs:
            np.testing.assert_allclose(float(got[0]), float(want[0]), **TOL)
            for gw, gg in ((want[1], got[1]), (want[2], got[2])):
                assert list(gg) == sorted(gw)
                for k in gw:
                    np.testing.assert_allclose(gg[k].numpy(),
                                               np.asarray(gw[k]), **TOL)


def _port_loop(cfg, groups, cc):
    """The port's counterpart of the reference cluster's train → sync →
    serve wiring, on the CPU."""
    plan = RoutingPlan(cc.num_master, cc.num_slave, cc.num_partitions)
    opt = get_optimizer("ftrl", alpha=cfg.ftrl_alpha, beta=cfg.ftrl_beta,
                        l1=cfg.ftrl_l1, l2=cfg.ftrl_l2)
    queue = PartitionedQueue(cc.num_partitions)
    transform = make_transform(cc.codec, opt, backend="torch", device="cpu")
    masters = [MasterShard(i, groups, opt, backend="torch", device="cpu")
               for i in range(cc.num_master)]
    cols = [port_st.Collector() for _ in masters]
    for m, c in zip(masters, cols):
        m.collector = c
    gathers = [port_st.Gatherer(cc.gather_mode) for _ in masters]
    pushers = [port_st.Pusher(m, queue, plan, transform) for m in masters]
    sets = [ReplicaSet([SlaveShard(sid, groups, backend="torch",
                                   device="cpu", codec_backend="torch")
                        for _ in range(cc.num_replicas)])
            for sid in range(cc.num_slave)]
    scatters = []
    for rs in sets:
        for shard in rs.replicas:
            sc = port_st.Scatter(shard, queue, plan)
            rs.attach_scatter(shard, sc)
            scatters.append(sc)
    serving = ServingPlane(plan, sets, groups, ps_backend="torch",
                           device="cpu", buckets=cc.serve_buckets)
    serving.add_scenario(cfg)
    for rs in sets:
        for shard in rs.replicas:
            shard.on_apply = serving.on_applied
    training = TrainingPlane(plan, masters, dict(groups), opt, device="cpu")
    training.add_scenario(cfg)

    def tick(now):
        for col, gat, push in zip(cols, gathers, pushers):
            gat.offer(col.drain())
            if gat.ready(now):
                push.push(gat.flush(now), now)
        for sc in scatters:
            sc.poll(now=now)

    return masters, sets, serving, training, tick


def test_small_loop_matches_cluster():
    """Train → int8 sync → serve against ``WeiPSCluster`` on its Pallas PS
    and codec backends. Master rows agree within 1e-5 relative: autograd
    rounds the gradients differently from JAX, and FTRL carries those
    ulps. Served rows agree within one int8 step of their row (absmax /
    127), since an ulp can move a quotient across a rounding boundary;
    predictions then agree within 2e-3, a code step through the 4 fields
    of the FM. Measured on this seed: 72 of 1,080 master elements differ,
    by at most 1.5e-8; served rows and predictions are equal."""
    cfg = dataclasses.replace(ref_cfgs.FM_FTRL, fields=4, ftrl_l1=0.01,
                              ftrl_alpha=0.2)
    pcfg = dataclasses.replace(port_cfgs.FM_FTRL, fields=4, ftrl_l1=0.01,
                               ftrl_alpha=0.2)
    cc = ClusterConfig(num_master=2, num_slave=2, num_replicas=2,
                       num_partitions=4, codec="int8",
                       codec_backend="pallas", ps_backend="pallas")
    cl = WeiPSCluster(cfg, cc)
    masters, sets, serving, training, tick = _port_loop(pcfg, cl.groups, cc)
    rng = np.random.default_rng(5)
    pool = _ids(rng, 40)
    for step in range(3):
        ids = pool[rng.integers(0, len(pool), size=(24, 4))]
        y = (rng.uniform(size=24) < 0.5).astype(np.float32)
        want = cl.train_on_batch(ids, y, now=float(step))
        got = training.train_batch(training.scenario(), ids, y,
                                   now=float(step))
        np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
        cl.sync_tick(float(step))
        tick(float(step))
    for g in cl.groups:
        for m, rm in zip(masters, cl.masters):
            live = rm.tables[g].all_ids()
            assert len(live) == len(m.tables[g])
            for a, b in zip(_rows_of(m.tables[g], live),
                            _rows_of(rm.tables[g], live)):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
        for rs, rrs in zip(sets, cl.replica_sets):
            for rep, rrep in zip(rs.replicas, rrs.replicas):
                ids = np.sort(rrep.tables[g].all_ids())
                a, b = rep.lookup(g, ids), rrep.lookup(g, ids)
                step = np.abs(b).max(axis=1, keepdims=True) / 127
                assert (np.abs(a - b) <= step * 1.001 + 1e-12).all()
    assert all(m.fused_batches == 3 * len(cl.groups) for m in masters)
    req = pool[rng.integers(0, len(pool), size=(16, 4))]
    p_want, p_got = cl.predict(req), serving.predict(req)
    assert np.isfinite(p_got).all() and p_got.shape == (16,)
    assert np.ptp(p_want) > 1e-3                   # weights are not all 0
    np.testing.assert_allclose(p_got, p_want, rtol=0, atol=2e-3)


def test_load_train_state_routes_and_merges():
    rng = np.random.default_rng(6)
    plan = RoutingPlan(3, 1, 1)
    masters = [MasterShard(i, {"v": 4}, get_optimizer("ftrl"),
                           backend="numpy", device="cpu") for i in range(3)]
    ids = _ids(rng, 90)
    cols = {k: rng.normal(size=(90, 4)).astype(np.float32)
            for k in ("w", "z", "n")}
    load_train_state(masters, plan, {"v": (
        ids[:60], cols["w"][:60], {"z": cols["z"][:60], "n": cols["n"][:60]})})
    load_train_state(masters, plan, {"v": (
        ids[30:], cols["w"][30:], {"z": cols["z"][30:], "n": cols["n"][30:]})})
    owner = plan.master_shard(ids)
    for mid, m in enumerate(masters):
        mine = owner == mid
        assert len(m.tables["v"]) == mine.sum()
        w, slots = m.tables["v"].gather(ids[mine])
        np.testing.assert_array_equal(w, cols["w"][mine])
        np.testing.assert_array_equal(slots["z"], cols["z"][mine])
    with pytest.raises(ValueError):
        load_train_state(masters, plan, {"v": (ids[:2], cols["w"][:2],
                                               {"m": cols["z"][:2]})})


def test_feature_filter_and_evaluator_match_reference():
    rng = np.random.default_rng(7)
    port, ref = (FeatureFilter(min_count=3, max_tracked=64),
                 RefFilter(min_count=3, max_tracked=64))
    for _ in range(6):
        ids = rng.integers(0, 200, size=80).astype(np.int64)
        np.testing.assert_array_equal(port.admit(ids), ref.admit(ids))
    assert port.trims == ref.trims > 0
    t = SparseTable(1, backend="numpy", device="cpu")
    t.scatter(np.arange(10, dtype=np.int64), np.ones((10, 1), np.float32),
              step=5)
    t.scatter(np.arange(5, dtype=np.int64), np.ones((5, 1), np.float32),
              step=50)
    np.testing.assert_array_equal(FeatureFilter(ttl_steps=10).expired(t, 40),
                                  np.arange(5, 10))
    ev, rev = StreamingEvaluator(window=3), RefEvaluator(window=3)
    for _ in range(5):
        y = (rng.uniform(size=64) < 0.3).astype(np.float32)
        p = rng.uniform(size=64).astype(np.float32)
        w = rng.uniform(size=64)
        assert ev.observe(0.0, 0, y, p, weights=w).values == \
            rev.observe(0.0, 0, y, p, weights=w).values
        assert auc(y, p) == ref_auc(y, p)
    assert ev.smoothed("auc") == rev.smoothed("auc")
