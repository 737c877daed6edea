"""The serving slice as a whole: the port's ``ServingPlane`` against the
JAX package's ``WeiPSCluster`` serving plane.

The reference cluster (``ps_backend="pallas"``, interpret mode) is
trained a step and synced, so its replicas hold FTRL serve weights; the
replicas' state is carried into the port with
``convert.load_serve_state``. Then both serve the same request sequence
— cold, warm, partial miss, and a partial miss after one replica of each
set is killed — for the FM scenario and an LR scenario reading the same
store. Served rows must be bit-equal; predictions within fp32
``rtol=1e-5, atol=1e-6``; replica pulls, device-resident blocks, cache
hits and misses, and failover counts equal (a killed replica is never
picked, so its set serves every miss from the live one). Run once with
placement routed by capacity and once with every table pinned to the
windowed "hbm" probe.
"""

import dataclasses

import numpy as np
import pytest

from repro.configs.weips_ctr import FM_FTRL, LR_FTRL
from repro.core.cluster import ClusterConfig, WeiPSCluster
from repro_torch.configs import weips_ctr as port_cfgs
from repro_torch.convert import load_serve_state
from repro_torch.core.fault_tolerance import ReplicaSet
from repro_torch.core.ps import SlaveShard
from repro_torch.core.routing import RoutingPlan
from repro_torch.serving import ServingPlane

FIELDS = 4


def _reference(placement, pool):
    cfg = dataclasses.replace(FM_FTRL, fields=FIELDS)
    cl = WeiPSCluster(cfg, ClusterConfig(
        num_master=1, num_slave=2, num_replicas=2, num_partitions=4,
        ps_backend="pallas"))
    cl.add_scenario(dataclasses.replace(LR_FTRL, fields=FIELDS))
    if placement == "hbm":
        for shard in (list(cl.masters) + [r for rs in cl.replica_sets
                                          for r in rs.replicas]):
            for t in shard.tables.values():
                t.device_placement = "hbm"
        for scn in cl.serving.registry:
            scn.cache.table.device_placement = "hbm"
    prng = np.random.default_rng(11)
    for mid, mids in cl.plan.split_by_master(pool).items():
        for g, dim in cl.groups.items():
            cl.masters[mid].apply_batch(
                g, mids, 3 * prng.normal(size=(len(mids), dim)).astype(
                    np.float32))
    cl.sync_tick(0.0)
    return cl


def _serve_state(cl):
    """Each group's rows across the slave shards (replica 0 of each)."""
    out = {}
    for g in cl.groups:
        snaps = [rs.replicas[0].tables[g].snapshot()
                 for rs in cl.replica_sets]
        out[g] = (np.concatenate([s["ids"] for s in snaps]),
                  np.concatenate([s["w"] for s in snaps]))
    return out


def _port(cl, placement):
    cfg = dataclasses.replace(port_cfgs.FM_FTRL, fields=FIELDS)
    plan = RoutingPlan(cl.plan.num_master, cl.plan.num_slave,
                       cl.plan.num_partitions)
    sets = [ReplicaSet([SlaveShard(sid, cl.groups, backend="torch",
                                   device="cpu") for _ in rs.replicas])
            for sid, rs in enumerate(cl.replica_sets)]
    load_serve_state(sets, plan, _serve_state(cl))
    plane = ServingPlane(plan, sets, cl.groups, ps_backend="torch",
                         device="cpu", buckets=cl.ccfg.serve_buckets)
    plane.add_scenario(cfg)
    plane.add_scenario(dataclasses.replace(port_cfgs.LR_FTRL, fields=FIELDS))
    if placement == "hbm":
        for rs in sets:
            for r in rs.replicas:
                for t in r.tables.values():
                    t.device_placement = "hbm"
        for scn in plane.registry:
            scn.cache.table.device_placement = "hbm"
    return plane


def _counters(plane, replica_sets):
    return {"pulled": plane.shard_pulled_rows,
            "device_blocks": plane.device_blocks,
            "failovers": [rs.failovers for rs in replica_sets],
            "caches": {s.name: (s.cache.hits, s.cache.misses, len(s.cache))
                       for s in plane.registry}}


@pytest.mark.parametrize("placement", ["auto", "hbm"])
def test_serving_slice_matches_reference(placement):
    rng = np.random.default_rng(0)
    pool = np.unique(rng.choice(1 << 40, size=96, replace=False))
    cl = _reference(placement, pool)
    plane = _port(cl, placement)

    cold = pool[rng.integers(0, len(pool), size=(6, FIELDS))]
    partial = cold.copy()
    partial[:2] = pool[rng.integers(0, len(pool), size=(2, FIELDS))]
    partial[2, 0] = (1 << 41) + 5                 # never stored: zeros
    after_kill = cold.copy()                      # misses served by the
    unseen = np.setdiff1d(pool, np.concatenate([cold, partial], None))
    after_kill[3:] = unseen[:3 * FIELDS].reshape(3, FIELDS)  # live replica
    steps = [("cold", cold), ("warm", cold), ("partial", partial),
             ("kill", after_kill)]
    max_dev = 0.0
    for label, req in steps:
        if label == "kill":
            for sid in range(len(cl.replica_sets)):
                cl.kill_slave_replica(sid, 0)
                plane.replica_sets[sid].replicas[0].kill()
        for scn in (None, "weips-lr-ftrl"):
            want = cl.serving.serve_rows(req, scn)
            got = plane.serve_rows(req, scn)
            assert set(got) == set(want)
            for g in want:
                np.testing.assert_array_equal(got[g], want[g],
                                              err_msg=f"{label} {g}")
            p_want = cl.serving.predict(req, scn)
            p_got = plane.predict(req, scn)
            max_dev = max(max_dev, float(np.abs(p_got - p_want).max()))
            np.testing.assert_allclose(p_got, p_want, rtol=1e-5, atol=1e-6)
        assert _counters(plane, plane.replica_sets) == \
            _counters(cl.serving, cl.replica_sets), label
    print(f"placement={placement}: max |port - reference| prediction "
          f"= {max_dev:.3g}")
    assert plane.device_blocks > 0
    assert not any(r.alive for r in
                   (rs.replicas[0] for rs in plane.replica_sets))
    if placement == "hbm":
        assert plane.scenario().cache.table.mirror_metrics()["placement"] \
            == "hbm"
