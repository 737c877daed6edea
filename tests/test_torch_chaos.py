"""The port's counterparts of ``tests/chaos/``: the chaos harness on the
port's multi-process runtime (``repro_torch.launch``), with every worker
on ``device="cpu"`` (the torch backends run the kernels' plain
versions), and the in-process plane chaos on the port's ``WeiPSCluster``
driven by the port's ``FaultPlan``.

The multi-process mirrors of ``test_chaos_runtime.py``,
``test_chaos_windows.py`` and ``test_chaos_trace.py`` carry the ``chaos``
marker, as the reference's do: opt in with ``RUN_CHAOS=1`` (or
``--chaos``); each runs under the conftest's ``--chaos-timeout``. The
mirror of ``test_chaos_planes.py`` runs in process and carries no
marker. Every comparison is bit for bit, as in the reference."""

from dataclasses import replace

import numpy as np
import pytest

from repro_torch.configs.weips_ctr import LR_FTRL
from repro_torch.core.cluster import ClusterConfig, WeiPSCluster
from repro_torch.launch.chaos import FaultEvent, FaultPlan
from repro_torch.obs import perfetto
from repro_torch.obs import trace as obs_trace
from torch_runtime_harness import (MASTERS, SLAVES, STEPS,
                                   assert_slaves_consistent,
                                   assert_states_equal, make_runtime,
                                   run_cluster)


@pytest.fixture(scope="module")
def fault_free_run(tmp_path_factory):
    """The no-fault trajectory every chaos run is compared against, run
    once per module."""
    return run_cluster(tmp_path_factory.mktemp("fault-free"))


# ---------------------------------------------------------------------------
# test_chaos_runtime.py
# ---------------------------------------------------------------------------
@pytest.mark.chaos
def test_slave_sigkill_recovers_and_serves(tmp_path):
    plan = FaultPlan(seed=0, events=[
        FaultEvent("slave-0.0", "pre_apply", 5, "kill")])
    out = run_cluster(tmp_path, plan)
    assert out["recoveries"] == 1
    assert_slaves_consistent(out["masters"], out["slaves"])


@pytest.mark.chaos
def test_master_sigkill_mid_train_recovers(tmp_path, fault_free_run):
    plan = FaultPlan(seed=0, events=[
        FaultEvent("master-1", "mid_train", 6, "kill")])
    out = run_cluster(tmp_path, plan)
    assert out["recoveries"] == 1
    assert_states_equal(out["masters"], fault_free_run["masters"],
                        "masters after mid_train kill")
    assert_states_equal(out["slaves"], fault_free_run["slaves"],
                        "slaves after mid_train kill")


@pytest.mark.chaos
def test_recovery_is_trajectory_preserving(tmp_path, fault_free_run,
                                           chaos_seed):
    for seed in (chaos_seed, chaos_seed + 4, chaos_seed + 16):
        plan = FaultPlan.generate(seed, steps=STEPS, masters=MASTERS,
                                  slaves=SLAVES)
        out = run_cluster(tmp_path / f"seed{seed}", plan)
        assert out["recoveries"] >= 1, \
            f"seed {seed}: plan had kills but nothing died"
        assert_states_equal(out["masters"], fault_free_run["masters"],
                            f"masters (seed {seed})")
        assert_states_equal(out["slaves"], fault_free_run["slaves"],
                            f"slaves (seed {seed})")


@pytest.mark.chaos
def test_domino_downgrade_fires_and_unfires(tmp_path):
    rt = make_runtime(
        tmp_path, optimizer_kwargs={"alpha": 0.5, "l1": 0.01},
        trigger_threshold=0.64, trigger_window=3, trigger_min_points=5,
        downgrade_cooldown=8.0)
    try:
        rt.start()
        rt.run_to(30)
        fired = rt.downgrader.downgrades
        assert len(fired) == 1, f"expected exactly one downgrade: {fired}"
        t0, v = fired[0]
        assert v in rt.store.versions()
        assert rt.downgrader.active(t0 + rt.downgrader.cooldown / 2)
        assert not rt.downgrader.active(float(rt.step))
        assert rt.evaluator.smoothed("logloss", 3) < 0.64
        assert_slaves_consistent(rt.master_state(), rt.slave_state())
    finally:
        rt.shutdown()


@pytest.mark.chaos
def test_elastic_add_remove_replica(tmp_path):
    rt = make_runtime(tmp_path)
    try:
        rt.start()
        rt.run_to(6)
        name = rt.add_replica(0)
        assert name == "slave-0.1"
        rt.run_to(10)
        slaves = rt.slave_state()
        assert np.array_equal(slaves["slave-0.0"]["ids"],
                              slaves["slave-0.1"]["ids"])
        assert np.array_equal(slaves["slave-0.0"]["w"],
                              slaves["slave-0.1"]["w"])
        rt.remove_replica(name)
        assert name not in rt.clients and name not in rt.procs
        rt.run_to(12)
        assert_slaves_consistent(rt.master_state(), rt.slave_state())
    finally:
        rt.shutdown()


# ---------------------------------------------------------------------------
# test_chaos_windows.py
# ---------------------------------------------------------------------------
@pytest.mark.chaos
def test_kill_between_flush_and_apply(tmp_path, fault_free_run):
    plan = FaultPlan(seed=0, events=[
        FaultEvent("master-0", "mid_flush", 6, "kill")])
    out = run_cluster(tmp_path, plan)
    assert out["recoveries"] == 1
    assert_states_equal(out["masters"], fault_free_run["masters"],
                        "masters after torn flush")
    assert_states_equal(out["slaves"], fault_free_run["slaves"],
                        "slaves after torn flush")


@pytest.mark.chaos
def test_kill_mid_delta_checkpoint(tmp_path, fault_free_run):
    plan = FaultPlan(seed=0, events=[
        FaultEvent("master-0", "mid_ckpt", 4, "kill")])
    rt = make_runtime(tmp_path, plan)
    try:
        rt.start()
        assert rt.store.versions() == [1]
        rt.run_to(14)
        assert rt.recoveries == 1
        vs = rt.store.versions()
        assert len(vs) >= 2
        for v in vs:
            snaps, seqs = rt.store.materialize(v)
            assert sorted(snaps) == [0, 1]
        post = rt.store.load(vs[1])
        assert post.kind == "full"
        assert post.base is None
        assert_states_equal(rt.master_state(), fault_free_run["masters"],
                            "masters after torn checkpoint")
        assert_states_equal(rt.slave_state(), fault_free_run["slaves"],
                            "slaves after torn checkpoint")
    finally:
        rt.shutdown()


@pytest.mark.chaos
def test_replica_bootstrap_races_live_stream(tmp_path):
    rt = make_runtime(tmp_path)
    try:
        rt.start()
        rt.run_to(7)
        name = rt.add_replica(1)
        rt.run_to(13)
        slaves = rt.slave_state()
        inc, new = slaves["slave-1.0"], slaves[name]
        assert len(inc["ids"])
        assert np.array_equal(inc["ids"], new["ids"])
        assert np.array_equal(inc["w"], new["w"])
        assert_slaves_consistent(rt.master_state(), slaves)
    finally:
        rt.shutdown()


@pytest.mark.chaos
def test_transport_drop_redelivers(tmp_path, fault_free_run):
    plan = FaultPlan(seed=0, events=[
        FaultEvent("slave-1.0", "pre_apply", 3, "drop"),
        FaultEvent("slave-1.0", "pre_apply", 9, "drop"),
        FaultEvent("master-1", "mid_flush", 5, "delay", 0.02)])
    out = run_cluster(tmp_path, plan)
    assert out["recoveries"] == 0
    assert_states_equal(out["slaves"], fault_free_run["slaves"],
                        "slaves after drops")


# ---------------------------------------------------------------------------
# test_chaos_trace.py
# ---------------------------------------------------------------------------
@pytest.fixture
def _reset_tracer():
    yield
    obs_trace.disable()


@pytest.mark.chaos
def test_kill_mid_flush_exports_one_causal_trace(tmp_path, _reset_tracer):
    plan = FaultPlan(seed=0, events=[
        FaultEvent("master-0", "mid_flush", 5, "kill")])
    rt = make_runtime(tmp_path, plan, trace=True)
    try:
        rt.start()
        warm = np.arange(rt.cfg.vocab, dtype=np.int64)
        for name in rt.slave_names():
            rt.clients[name].call("lookup", group="emb", ids=warm)
        rt.run_to(STEPS)
        path = str(tmp_path / "chaos_trace.json")
        n = rt.export_trace(path)
        assert n > 0
        metrics = rt.cluster_metrics()
    finally:
        rt.shutdown()

    assert rt.recoveries == 1
    spans = perfetto.load_spans(path)
    by_name: dict = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)

    kills = by_name.get("fault.kill", [])
    assert kills, "killed worker's pre-kill dump is missing"
    assert kills[0]["proc"] == "master-0"
    assert kills[0]["t1"] is None
    assert kills[0]["args"]["point"] == "mid_flush"

    assert by_name.get("fault.detected")
    recs = by_name.get("recover", [])
    assert recs and recs[0]["proc"] == "supervisor"
    assert "master-0" in recs[0]["args"]["workers"]
    assert by_name.get("driver.step") and by_name.get("ckpt.commit")

    ids = {s["span"] for s in spans}
    for s in spans:
        assert s["parent"] == 0 or s["parent"] in ids, \
            f"orphaned parent on {s['name']}: {s['parent']:#x}"

    pushes = {s["span"]: s for s in by_name.get("sync.push", [])}
    queues = by_name.get("sync.queue", [])
    applies = {s["span"]: s for s in by_name.get("sync.apply", [])}
    assert pushes and queues and applies
    crossed = 0
    for q in queues:
        push = pushes[q["parent"]]
        assert push["trace"] == q["trace"]
        assert push["proc"].startswith("master-")
        assert q["proc"] in SLAVES
        if push["proc"] != q["proc"]:
            crossed += 1
    assert crossed, "no trace crossed a process boundary"
    for a in applies.values():
        parent = next(q for q in queues if q["span"] == a["parent"])
        assert parent["trace"] == a["trace"]
        assert parent["proc"] == a["proc"]

    invs = by_name.get("cache.invalidate", [])
    assert invs, "no cache.invalidate spans despite warmed caches"
    for inv in invs:
        assert inv["parent"] in applies
        assert inv["trace"] == applies[inv["parent"]]["trace"]

    m0_salts = {s["span"] >> 32 for s in spans
                if s["proc"] == "master-0"}
    assert len(m0_salts) >= 2, \
        "expected spans from both lives of master-0"

    assert metrics["recoveries"] == 1
    assert metrics["aggregate"]["applied"] > 0
    slave_trees = [m for n, m in metrics["workers"].items()
                   if n.startswith("slave-") and m]
    assert slave_trees
    for t in slave_trees:
        assert t["cache"]["invalidated"] > 0


# ---------------------------------------------------------------------------
# test_chaos_planes.py: in process, tier-1 (no marker)
# ---------------------------------------------------------------------------
SPACE = 1 << 10
FIELDS = 4
PLANE_STEPS = 12
CKPT_EVERY = 4
BUDGET = 64
SERVE_REQS = 3
REQ_N = 48

CFG = replace(LR_FTRL, fields=FIELDS, feature_space=SPACE)


def make_cluster() -> WeiPSCluster:
    return WeiPSCluster(CFG, ClusterConfig(
        num_master=2, num_slave=2, num_replicas=2, num_partitions=4,
        serve_max_pending=2 * BUDGET, seed=9, device="cpu"))


def train_batch_for(step: int, n: int = 32):
    rng = np.random.default_rng(1000 + step)
    ids = (rng.zipf(1.3, size=(n, FIELDS)) % SPACE).astype(np.int64)
    return ids, (rng.random(n) < 0.5).astype(np.float32)


def serve_batch_for(step: int, r: int) -> np.ndarray:
    rng = np.random.default_rng(5000 + 31 * step + r)
    return (rng.zipf(1.3, size=(REQ_N, FIELDS)) % SPACE).astype(np.int64)


def run_planes(plan: FaultPlan = None, steps: int = PLANE_STEPS):
    """The reference test's closed-loop serve+train driver, on the port's
    cluster: slave targets die mid-predict-stream, master targets
    mid-train-flush (restore ALL masters from the latest cut, rewind,
    replay)."""
    cl = make_cluster()
    events = list(plan.kills()) if plan is not None else []
    fired = set()
    preds: dict[int, list] = {}
    recoveries = 0
    ckpt_step = 0
    cl.checkpoint(0.0)
    step = 0
    while step < steps:
        now = float(step + 1)
        due = [e for e in events if e.step == step and e not in fired]
        ids, y = train_batch_for(step)
        cl.train_on_batch(ids, y, now=now)
        dead_master = next((e for e in due
                            if e.target.startswith("master-")), None)
        if dead_master is not None:
            fired.add(dead_master)
            cl.kill_master(int(dead_master.target.split("-")[1]))
            cl.cold_backup.recover_all(cl.masters)
            recoveries += 1
            step = ckpt_step
            continue
        cl.sync_tick(now)
        for r in range(SERVE_REQS):
            cl.serving.submit(serve_batch_for(step, r))
        for e in due:
            if e.target.startswith("slave-"):
                fired.add(e)
                sid, rid = e.target.split("-")[1].split(".")
                cl.kill_slave_replica(int(sid), int(rid))
        out = cl.serving.flush(budget=BUDGET)
        preds[step] = [p for p in out if p is not None]
        step += 1
        if step % CKPT_EVERY == 0:
            cl.checkpoint(float(step))
            ckpt_step = step
    cl.sync_tick(float(steps + 1))
    return cl, preds, recoveries


def master_tables(cl: WeiPSCluster) -> dict:
    out = {}
    for m in cl.masters:
        for g, t in m.tables.items():
            ids = np.sort(t.all_ids())
            w, _ = t.gather(ids)
            out[(m.shard_id, g)] = (ids, w)
    return out


def slave_tables(cl: WeiPSCluster) -> dict:
    out = {}
    for sid, rs in enumerate(cl.replica_sets):
        for rid, shard in enumerate(rs.replicas):
            if not shard.alive:
                continue
            for g, t in shard.tables.items():
                ids = np.sort(t.all_ids())
                out[(sid, rid, g)] = (ids, shard.lookup(g, ids))
    return out


def assert_tables_equal(got: dict, want: dict, what: str) -> None:
    assert sorted(got) == sorted(want), f"{what}: key sets differ"
    for k in want:
        np.testing.assert_array_equal(got[k][0], want[k][0],
                                      err_msg=f"{what}: ids of {k}")
        np.testing.assert_array_equal(got[k][1], want[k][1],
                                      err_msg=f"{what}: values of {k}")


@pytest.fixture(scope="module")
def planes_base():
    return run_planes(None)


def test_slave_dies_mid_predict_stream(planes_base):
    base_cl, base_preds, _ = planes_base
    plan = FaultPlan(seed=3, events=[
        FaultEvent("slave-0.1", "pre_apply", 5, "kill")])
    cl, preds, _ = run_planes(plan)
    assert sorted(preds) == sorted(base_preds)
    for s in base_preds:
        assert len(preds[s]) == len(base_preds[s]), f"step {s}"
        for a, b in zip(preds[s], base_preds[s]):
            np.testing.assert_array_equal(a, b, err_msg=f"step {s}")
    assert cl.replica_sets[0].failovers > 0 or \
        not cl.replica_sets[0].replicas[1].alive
    adm = cl.serving.metrics()["admission"]
    assert adm["shed_examples"] > 0
    pending = sum(s.scheduler.pending_examples
                  for s in cl.serving.registry)
    assert adm["executed_examples"] + adm["shed_examples"] + pending \
        == adm["offered_examples"]
    assert adm == base_cl.serving.metrics()["admission"]


def test_master_kill_mid_train_flush_replays_bit_equal(planes_base):
    kill_step = 6
    base_cl, base_preds, base_rec = planes_base
    assert base_rec == 0
    plan = FaultPlan(seed=4, events=[
        FaultEvent("master-1", "mid_flush", kill_step, "kill")])
    cl, preds, recoveries = run_planes(plan)
    assert recoveries == 1
    assert all(m.alive for m in cl.masters)
    assert_tables_equal(master_tables(cl), master_tables(base_cl),
                        "masters after mid-flush kill")
    assert_tables_equal(slave_tables(cl), slave_tables(base_cl),
                        "slaves after mid-flush kill")
    for s in range(kill_step, PLANE_STEPS):
        assert len(preds[s]) == len(base_preds[s]), f"step {s}"
        for a, b in zip(preds[s], base_preds[s]):
            np.testing.assert_array_equal(a, b, err_msg=f"step {s}")


def test_generated_plan_planes_survive(planes_base):
    want = master_tables(planes_base[0])
    for seed in (11, 23):
        gen = FaultPlan.generate(seed, steps=PLANE_STEPS,
                                 masters=["master-0", "master-1"],
                                 slaves=["slave-0.1", "slave-1.1"])
        plan = FaultPlan(seed=seed, events=gen.kills()[:1])
        cl, preds, _ = run_planes(plan)
        assert len(preds) == PLANE_STEPS
        assert_tables_equal(master_tables(cl), want,
                            f"masters (seed {seed})")
        for rs in cl.replica_sets:
            assert any(sh.alive for sh in rs.replicas)
        adm = cl.serving.metrics()["admission"]
        pending = sum(s.scheduler.pending_examples
                      for s in cl.serving.registry)
        assert adm["executed_examples"] + adm["shed_examples"] \
            + pending == adm["offered_examples"]
