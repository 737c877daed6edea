"""The port's multi-process cluster runtime (``repro_torch.launch``)
against the JAX package's, on the CPU.

The transport's semantics (a round trip, an ``"err"`` reply raises
``RuntimeError`` with the remote traceback, a killed server raises
``WorkerDied``); ``FaultPlan`` generation and its JSON equal to the
reference's for the same seeds; the process mesh and launch specs; the
``ManifestStore`` chain; and whole runs of the process-per-shard grid at
the chaos suite's shape (``tests/chaos/_harness.py`` ``CLUSTER_KW``, 14
steps): the port's workers on ``device="cpu"`` (the torch backends run
the kernels' plain versions; the numpy backends the host paths) against
the reference's ``ClusterRuntime``, and a ``mid_train`` SIGKILL against
the port's own fault-free run. Tolerance: none — master and slave
tables (ids, w, slots) are compared bit for bit, the reference being
exact on this path (FTRL rows, the int8 codec).

Every test that starts processes runs under its own wall-clock limit
(``_deadline``): the conftest's chaos deadline only covers tests marked
``chaos``."""

import dataclasses
import os
import pickle
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

from repro.launch import chaos as ref_chaos
from repro.launch import mesh as ref_mesh
from repro.launch import runtime as ref_runtime
from repro.launch import specs as ref_specs
from repro_torch.launch import chaos, mesh, specs, worker
from repro_torch.launch.chaos import FaultEvent, FaultHooks, FaultPlan
from repro_torch.launch.runtime import (ClusterRuntime, Manifest,
                                        ManifestStore, RuntimeConfig)
from repro_torch.launch.transport import RpcClient, WorkerDied
from torch_runtime_harness import (CLUSTER_KW, ENGINES, MASTERS, SLAVES,
                                   STEPS, assert_states_equal, run_cluster)

SRC = Path(__file__).resolve().parents[1] / "src"
DEADLINE_S = 120


@pytest.fixture(autouse=True)
def _deadline():
    """A wall-clock limit on every test of this file: a worker that never
    binds its socket, or a supervisor waiting on a dead one, fails with
    ``TimeoutError`` instead of hanging the run."""
    def on_alarm(signum, frame):
        raise TimeoutError(f"test exceeded {DEADLINE_S} s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(DEADLINE_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------
_SERVER = textwrap.dedent("""
    import os
    import sys
    import numpy as np
    sys.path.insert(0, {src!r})
    from repro_torch.launch.transport import RpcServer

    def handler(method, kw):
        if method == "echo":
            return {{"x": np.asarray(kw["x"]) * 2, "pid": os.getpid()}}
        raise ValueError(f"no method {{method}}")

    RpcServer({sock!r}, handler).serve_forever()
""")


@pytest.fixture
def server(tmp_path):
    sock = str(tmp_path / "sock" / "w.sock")
    proc = subprocess.Popen([sys.executable, "-c",
                             _SERVER.format(src=str(SRC), sock=sock)])
    client = RpcClient(sock, connect_timeout=30.0)
    yield proc, client
    client.close()
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def test_transport_round_trip_and_shutdown(server):
    proc, client = server
    out = client.call("echo", x=np.arange(5, dtype=np.int64))
    np.testing.assert_array_equal(out["x"], np.arange(5) * 2)
    assert out["x"].dtype == np.int64
    assert out["pid"] == proc.pid
    assert client.call("shutdown") is None
    assert proc.wait(timeout=10) == 0


def test_transport_err_reply_raises_with_remote_traceback(server):
    _, client = server
    with pytest.raises(RuntimeError) as e:
        client.call("nope", x=1)
    assert "ValueError: no method nope" in str(e.value)
    assert "Traceback" in str(e.value)
    # the connection survives an error reply
    assert client.call("echo", x=3)["x"] == 6


def test_transport_killed_server_raises_worker_died(server):
    proc, client = server
    client.call("echo", x=1)
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    with pytest.raises(WorkerDied):
        client.call("echo", x=1)
    assert client._conn is None


def test_transport_connect_timeout_raises_worker_died(tmp_path):
    client = RpcClient(str(tmp_path / "absent.sock"), connect_timeout=0.2)
    with pytest.raises(WorkerDied):
        client.connect()


# ---------------------------------------------------------------------------
# FaultPlan and FaultHooks
# ---------------------------------------------------------------------------
PLAN_SHAPES = [
    dict(steps=STEPS, masters=MASTERS, slaves=SLAVES),
    dict(steps=24, masters=[f"master-{i}" for i in range(4)],
         slaves=["slave-0.0", "slave-0.1", "slave-1.0", "slave-1.1"],
         kills=4, delays=2, drops=2, skews=1, skew=3.0, delay=0.01),
    dict(steps=5, masters=["master-0"], slaves=[], kills=3),
]


@pytest.mark.parametrize("seed", [0, 7, 11, 23, 1234])
@pytest.mark.parametrize("shape", range(len(PLAN_SHAPES)))
def test_fault_plan_equals_reference(seed, shape):
    kw = PLAN_SHAPES[shape]
    ours = FaultPlan.generate(seed, **kw)
    ref = ref_chaos.FaultPlan.generate(seed, **kw)
    assert ours.to_json() == ref.to_json()
    assert [dataclasses.asdict(e) for e in ours.events] == \
        [dataclasses.asdict(e) for e in ref.events]
    back = FaultPlan.from_json(ref.to_json())
    assert back.events == ours.events and back.seed == seed
    assert ref_chaos.FaultPlan.from_json(ours.to_json()).events == \
        ref.events
    assert len(ours.kills()) == kw.get("kills", 2)
    assert all(e.point in chaos.KILL_POINTS for e in ours.events)


def test_fault_plan_deterministic():
    """The port's mirror of ``tests/chaos``' in-process plan test."""
    for seed in (7, 11, 23):
        a = FaultPlan.generate(seed, steps=STEPS, masters=MASTERS,
                               slaves=SLAVES)
        b = FaultPlan.generate(seed, steps=STEPS, masters=MASTERS,
                               slaves=SLAVES)
        assert a.events == b.events
        assert FaultPlan.from_json(a.to_json()).events == a.events
        assert len(a.kills()) == 2
        for e in a.events:
            assert e.point in chaos.KILL_POINTS
            assert 1 <= e.step <= STEPS - 2
    assert FaultPlan.generate(7, steps=STEPS, masters=MASTERS,
                              slaves=SLAVES).events != \
        FaultPlan.generate(8, steps=STEPS, masters=MASTERS,
                           slaves=SLAVES).events


def test_fault_hooks_drop_delay_skew_and_on_fire():
    hooks = FaultHooks("slave-0.0", [
        FaultEvent("slave-0.0", "pre_apply", 3, "drop"),
        FaultEvent("slave-0.0", "pre_apply", 4, "delay", 0.01),
        FaultEvent("slave-0.0", "pre_apply", 4, "skew", 2.5),
        FaultEvent("slave-1.0", "pre_apply", 3, "drop")])
    seen = []
    hooks.on_fire = seen.append
    assert hooks.pending("pre_apply", 3, kind="drop") is not None
    assert hooks.pending("pre_apply", 3, kind="kill") is None
    assert not hooks.check("pre_apply", 2)
    assert hooks.check("pre_apply", 3)
    assert not hooks.check("pre_apply", 3)          # fired once
    t = time.perf_counter()
    assert not hooks.check("pre_apply", 4)
    assert time.perf_counter() - t >= 0.01
    assert hooks.now(10.0) == 12.5
    assert [e.kind for e in seen] == ["drop", "delay", "skew"]
    assert [e.kind for e in hooks.fired] == ["drop", "delay", "skew"]
    # the other target's event is never armed here
    assert len(hooks.events) == 1 and hooks.events[0].target == "slave-1.0"


def test_fault_hooks_kill_sigkills_the_process():
    script = (f"import sys; sys.path.insert(0, {str(SRC)!r})\n"
              "from repro_torch.launch.chaos import FaultEvent, FaultHooks\n"
              "h = FaultHooks('master-0', [FaultEvent('master-0', "
              "'mid_train', 2)])\n"
              "h.check('mid_train', 1)\nprint('alive', flush=True)\n"
              "h.check('mid_train', 2)\nprint('after', flush=True)\n")
    out = subprocess.run([sys.executable, "-c", script],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == -signal.SIGKILL
    assert out.stdout.split() == ["alive"]


# ---------------------------------------------------------------------------
# mesh and specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 1), (4, 2, 2),
                                   (3, 1, 4)])
def test_process_mesh_and_specs_equal_reference(shape, tmp_path):
    ours = mesh.make_process_mesh(*shape)
    ref = ref_mesh.make_process_mesh(*shape)
    assert [dataclasses.astuple(s) for s in ours.slots()] == \
        [dataclasses.astuple(s) for s in ref.slots()]
    assert [s.name for s in ours.slots()] == [s.name for s in ref.slots()]
    assert [s.name for s in ours.masters()] == \
        [s.name for s in ref.masters()]
    root = str(tmp_path)
    got = specs.plan_cluster_procs(ours, root)
    want = ref_specs.plan_cluster_procs(ref, root)
    assert [(s.name, s.socket, s.log_path, s.root) for s in got] == \
        [(s.name, s.socket, s.log_path, s.root) for s in want]
    for g, w in zip(got, want):
        assert g.argv[:3] == (sys.executable, "-m",
                              "repro_torch.launch.worker")
        assert w.argv[2] == "repro.launch.worker"
        assert g.argv[3:] == w.argv[3:]


@pytest.mark.parametrize("bad", [(0, 1, 1), (1, 0, 1), (1, 1, 0)])
def test_process_mesh_raises_value_error(bad):
    with pytest.raises(ValueError):
        mesh.make_process_mesh(*bad)


# ---------------------------------------------------------------------------
# ManifestStore
# ---------------------------------------------------------------------------
def _chain_store(root: Path):
    """Three versions written by two numpy-backend master shards: a full
    at step 0, then two deltas, each after a round of FTRL pushes, and a
    delta whose rows are deleted in part."""
    from repro_torch.core.ps import MasterShard
    from repro_torch.optim import get_optimizer
    opt = get_optimizer("ftrl")
    shards = [MasterShard(m, {"emb": 1}, opt, backend="numpy", device="cpu")
              for m in range(2)]
    store = ManifestStore(str(root))
    rng = np.random.default_rng(5)
    marks: dict = {}
    base = None
    for v in (1, 2, 3):
        if v > 1:
            for m, sh in enumerate(shards):
                ids = rng.integers(0, 200, 40) * 2 + m
                sh.apply_batch("emb", ids, rng.normal(
                    size=(40, 1)).astype(np.float32), step=v)
            if v == 3:
                shards[0].delete_rows("emb", shards[0].tables["emb"]
                                      .all_ids()[:5])
        parts = {}
        for m, sh in enumerate(shards):
            snap = sh.snapshot() if v == 1 else sh.delta_snapshot(
                marks.get(m, {}), {})
            path = store.part_path(v, m)
            with open(path, "wb") as f:
                pickle.dump({"snap": snap, "kind": "full" if v == 1
                             else "delta", "pusher_seqs": {"emb": v * 10 + m}},
                            f, protocol=4)
            parts[m] = os.path.basename(path)
            marks[m] = {g: t["version"] for g, t in snap["tables"].items()}
        store.commit(Manifest(version=v, kind="full" if v == 1 else "delta",
                              base=base, step=v * 4,
                              queue_offsets={0: v, 1: 2 * v}, parts=parts))
        base = v
    return store, shards


def test_manifest_store_chain_and_materialize(tmp_path):
    store, shards = _chain_store(tmp_path / "ckpt")
    assert store.versions() == [1, 2, 3] and store.latest() == 3
    assert [m.version for m in store.chain(3)] == [1, 2, 3]
    man = store.load(3)
    assert man.queue_offsets == {0: 3, 1: 6} and man.step == 12
    snaps, seqs = store.materialize(3)
    assert seqs == {0: {"emb": 30}, 1: {"emb": 31}}
    for m, sh in enumerate(shards):
        got = snaps[m]["tables"]["emb"]
        want = sh.snapshot()["tables"]["emb"]
        o, p = np.argsort(got["ids"]), np.argsort(want["ids"])
        np.testing.assert_array_equal(got["ids"][o], want["ids"][p])
        np.testing.assert_array_equal(got["w"][o], want["w"][p])
        for n in ("z", "n"):
            np.testing.assert_array_equal(got["slots"][n][o],
                                          want["slots"][n][p])
    # the reference's store reads the same files to the same state
    ref = ref_runtime.ManifestStore(str(tmp_path / "ckpt"))
    rsnaps, rseqs = ref.materialize(3)
    assert rseqs == seqs
    for m in snaps:
        a, b = snaps[m]["tables"]["emb"], rsnaps[m]["tables"]["emb"]
        for k in ("ids", "w", "last_touch", "touch_count"):
            np.testing.assert_array_equal(a[k], b[k])


def test_manifest_store_delta_without_base_raises(tmp_path):
    store = ManifestStore(str(tmp_path), codec_backend="numpy",
                          device="cpu")
    store.commit(Manifest(version=4, kind="delta", base=None, step=0,
                          queue_offsets={}, parts={}))
    with pytest.raises(RuntimeError, match="no base"):
        store.chain(4)


# ---------------------------------------------------------------------------
# the supervisor: configuration
# ---------------------------------------------------------------------------
def test_cuda_without_a_card_raises_before_any_spawn(tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = tmp_path / "rt"
    with pytest.raises(RuntimeError, match="cuda"):
        ClusterRuntime(RuntimeConfig(root=str(root), **CLUSTER_KW))
    with pytest.raises(RuntimeError, match="cuda"):
        ClusterRuntime(RuntimeConfig(root=str(root), device="cuda:0",
                                     ps_backend="numpy",
                                     codec_backend="numpy", **CLUSTER_KW))
    assert not root.exists()            # nothing written, nothing spawned


@pytest.mark.parametrize("bad", [dict(ps_backend="pallas"),
                                 dict(codec_backend="jax"),
                                 dict(device="meta")])
def test_runtime_config_rejects_unknown_engines(tmp_path, bad):
    kw = dict(ENGINES["torch"], **bad)
    with pytest.raises(ValueError):
        ClusterRuntime(RuntimeConfig(root=str(tmp_path / "rt"), **kw))
    assert not (tmp_path / "rt").exists()


def test_remove_replica_of_a_master_raises(tmp_path):
    rt = ClusterRuntime(RuntimeConfig(root=str(tmp_path), **CLUSTER_KW,
                                      **ENGINES["numpy"]))
    try:
        with pytest.raises(ValueError):
            rt.remove_replica("master-0")
    finally:
        rt.shutdown()


def test_fork_server_forks_reaps_and_stops(tmp_path):
    """Every worker is forked by the runtime's fork server; a SIGKILLed
    one is reaped at once (``poll`` gives -1), a live one times out a
    ``wait``; ``shutdown`` ends the workers and the server."""
    from torch_runtime_harness import make_runtime
    rt = make_runtime(tmp_path, **ENGINES["numpy"])
    try:
        rt.start()
        server = rt._fork_server
        assert len({p.pid for p in rt.procs.values()}) == 4
        for p in rt.procs.values():
            with open(f"/proc/{p.pid}/stat") as f:
                assert int(f.read().rsplit(")", 1)[1].split()[1]) == \
                    server.pid
        victim = rt.procs["master-1"]
        os.kill(victim.pid, signal.SIGKILL)
        assert victim.wait(timeout=10) == -1
        assert rt._dead() == ["master-1"]
        with pytest.raises(subprocess.TimeoutExpired):
            rt.procs["master-0"].wait(timeout=0.05)
    finally:
        rt.shutdown()
    assert server.poll() is not None
    assert all(p.poll() == -1 for p in rt.procs.values())


# ---------------------------------------------------------------------------
# the workers in process: their engines and their kernels counters
# ---------------------------------------------------------------------------
def _worker_cfg(tmp_path, engine: str, codec: str = "int8") -> dict:
    from repro_torch.core.queue import FileQueue
    FileQueue(str(tmp_path / "queue"), 4).close()
    return dict(num_master=2, num_slave=2, num_partitions=4,
                groups={"emb": 1, "v": 4}, optimizer="ftrl",
                optimizer_kwargs={"l1": 0.01}, codec=codec,
                serve_cache_rows=64, **{"device": "cpu", "ps_backend": engine,
                                        "codec_backend": engine})


@pytest.mark.parametrize("engine", ["torch", "numpy"])
def test_workers_build_on_runtime_engines(tmp_path, engine):
    cfg = _worker_cfg(tmp_path, engine)
    m = worker.MasterWorker(0, str(tmp_path), cfg)
    s = worker.SlaveWorker(1, 0, str(tmp_path), cfg)
    try:
        tables = [*m.shard.tables.values(), *s.shard.tables.values(),
                  s.cache.table]
        assert {t.backend for t in tables} == {engine}
        assert m.transform.backend == engine
        assert s.shard.codec_backend == engine
        ids = np.arange(0, 64, 2, dtype=np.int64)
        m.apply("emb", ids, np.ones((len(ids), 1), np.float32), step=0)
        assert m.flush(step=0, now=0.0) > 0
        s.clear()                       # the hot-switch prelude
        assert {t.backend for t in s.shard.tables.values()} == {engine}
        if engine == "torch":
            assert {str(t.device) for t in s.shard.tables.values()} == \
                {"cpu"}
        tree = m.metrics()
        assert set(tree["kernels"]) >= {"hashmap_probe", "ftrl_row_update",
                                        "quantize_rows", "dequantize_rows"}
        assert "kernels" in s.metrics()
        assert worker._dispatch(m, "ping", {}) == "master-0"
        with pytest.raises(AttributeError):
            worker._dispatch(m, "_build_registry", {})
    finally:
        m.queue.close()
        s.queue.close()


# ---------------------------------------------------------------------------
# whole runs: the port's process grid against the reference's
# ---------------------------------------------------------------------------
def _ref_runtime(root, plan=None, **kw):
    return ref_runtime.ClusterRuntime(ref_runtime.RuntimeConfig(
        root=str(root), **CLUSTER_KW, **kw), plan)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One run a (package, codec, engine), shared by the tests below."""
    cache: dict = {}

    def get(pkg: str, codec: str, engine: str = "torch"):
        key = (pkg, codec, engine)
        if key not in cache:
            root = tmp_path_factory.mktemp(f"{pkg}-{codec}-{engine}")
            if pkg == "ref":
                cache[key] = run_cluster(root, codec=codec,
                                         runtime=_ref_runtime)
            else:
                cache[key] = run_cluster(root, codec=codec,
                                         **ENGINES[engine])
        return cache[key]
    return get


@pytest.mark.parametrize("engine", ["torch", "numpy"])
@pytest.mark.parametrize("codec", ["identity", "int8"])
def test_fault_free_run_equals_reference(runs, codec, engine):
    ours, ref = runs("port", codec, engine), runs("ref", codec)
    assert ours["recoveries"] == ref["recoveries"] == 0
    assert_states_equal(ours["masters"], ref["masters"],
                        f"masters ({codec}, {engine})")
    assert_states_equal(ours["slaves"], ref["slaves"],
                        f"slaves ({codec}, {engine})")
    assert ours["offsets"] == ref["offsets"]
    agg, ref_agg = ours["metrics"]["aggregate"], ref["metrics"]["aggregate"]
    for k in ("pushed_records", "applied", "skipped"):
        assert agg[k] == ref_agg[k], k


@pytest.mark.parametrize("codec", ["identity", "int8"])
def test_worker_metrics_keep_reference_keys_and_add_kernels(runs, codec):
    ours, ref = runs("port", codec), runs("ref", codec)
    for name, tree in ref["metrics"]["workers"].items():
        got = ours["metrics"]["workers"][name]
        assert set(got) - set(tree) == {"kernels"}, name
        assert set(tree) <= set(got), name
        # the CPU runs the plain versions: no kernel launched
        assert set(got["kernels"].values()) == {0}
    assert set(ours["metrics"]) == set(ref["metrics"])


@pytest.mark.parametrize("codec", ["identity", "int8"])
def test_master_kill_mid_train_recovers_bit_equal(runs, tmp_path, codec):
    """master-0 SIGKILLed right after its optimizer state moved: one
    recovery, and masters and slaves bit-equal to the fault-free run."""
    plan = FaultPlan(seed=0, events=[
        FaultEvent("master-0", "mid_train", 6, "kill")])
    out = run_cluster(tmp_path, plan, codec=codec)
    base = runs("port", codec)
    assert out["recoveries"] == 1
    assert out["last_recovery"]["workers"] == ["master-0"]
    assert_states_equal(out["masters"], base["masters"],
                        "masters after mid_train kill")
    assert_states_equal(out["slaves"], base["slaves"],
                        "slaves after mid_train kill")


def test_slave_kill_and_elastic_replica_match_fault_free(runs, tmp_path):
    """A slave replica SIGKILLed at ``pre_apply`` bootstraps from the chain
    and the stream; a replica added at step 7 and removed at 11 comes
    and goes; masters and the incumbent slaves end bit-equal to the
    fault-free run, and the added replica equal to its shard's peer."""
    from torch_runtime_harness import make_runtime, summary
    plan = FaultPlan(seed=0, events=[
        FaultEvent("slave-0.0", "pre_apply", 5, "kill"),
        FaultEvent("slave-1.0", "pre_apply", 3, "drop")])
    rt = make_runtime(tmp_path, plan, codec="int8")
    try:
        rt.start()
        rt.run_to(7)
        name = rt.add_replica(1)
        assert name == "slave-1.1"
        rt.run_to(11)
        added = rt.slave_state()[name]
        peer = rt.slave_state()["slave-1.0"]
        assert np.array_equal(added["ids"], peer["ids"])
        assert np.array_equal(added["w"], peer["w"])
        rt.remove_replica(name)
        assert name not in rt.clients and name not in rt.specs
        rt.run_to(STEPS)
        out = summary(rt)
    finally:
        rt.shutdown()
    base = runs("port", "int8")
    assert out["recoveries"] == 1
    assert out["last_recovery"]["workers"] == ["slave-0.0"]
    assert_states_equal(out["masters"], base["masters"], "masters")
    assert_states_equal(out["slaves"], base["slaves"], "slaves")
    # the replay re-pushes the rewound steps' records, so the consumers'
    # offsets run ahead of the fault-free run's
    assert set(out["offsets"]) == set(base["offsets"])
    for name, offs in out["offsets"].items():
        assert all(offs[p] >= base["offsets"][name][p] for p in offs)
