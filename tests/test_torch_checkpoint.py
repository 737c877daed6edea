"""The port's checkpoint plane against the JAX package's, on the CPU.

Master shards of both packages take the same seeded pushes (duplicate and
unsorted ids through FTRL), evictions and dense puts. Then, bit for bit:
full and delta snapshots; the checkpoints ``ColdBackup`` writes on the
same cadence (versions, kinds, bases, payloads, plain and int8); the
int8 blocks against the reference's NumPy codec and, on one small case,
its Pallas kernel in interpret mode; ``fold_chain`` / ``materialize``;
``merge_shard_tables``; ``recover_shard`` and a 4 → 3 ``recover_all``;
``CheckpointStore`` retention, demotion and cascade drops; and a chain
the reference wrote, carried over with ``convert.load_checkpoint`` and
restored into the port's masters. The port runs its ``numpy`` and
``torch`` backends (``device="cpu"``: the kernels' plain versions)."""

import dataclasses
import random

import numpy as np
import pytest

from repro.core import fault_tolerance as ref_ft
from repro.core.ps import MasterShard as RefMaster
from repro.core.queue import PartitionedQueue as RefQueue
from repro.core.queue import Record as RefRecord
from repro.core.routing import RoutingPlan as RefPlan
from repro.optim import get_optimizer as ref_get_optimizer
from repro_torch.convert import load_checkpoint
from repro_torch.core import fault_tolerance as ft
from repro_torch.core.ps import MasterShard
from repro_torch.core.queue import PartitionedQueue, Record
from repro_torch.core.routing import RoutingPlan
from repro_torch.optim import get_optimizer

GROUPS = {"w": 1, "v": 8}
FTRL_KW = dict(alpha=0.1, beta=1.0, l1=0.05, l2=0.2)
BACKENDS = ["numpy", "torch"]


def assert_same(a, b, path="snap"):
    """Nested dicts / lists / arrays / scalars equal bit for bit."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b, path


def _pair(n, backend, seed=0):
    port = [MasterShard(i, GROUPS, get_optimizer("ftrl", **FTRL_KW),
                        backend=backend, device="cpu") for i in range(n)]
    ref = [RefMaster(i, GROUPS, ref_get_optimizer("ftrl", **FTRL_KW))
           for i in range(n)]
    return port, ref


class _Driver:
    """Seeded traffic for both packages' shards: pushes through each
    group's owner master, evictions, dense puts."""

    def __init__(self, n, seed):
        self.rng = np.random.default_rng(seed)
        self.plan = RoutingPlan(n, 1, 1)
        self.pool = self.rng.choice(1 << 40, size=300,
                                    replace=False).astype(np.int64)
        self.step = 0

    def push(self, sides, k=160):
        for g, dim in GROUPS.items():
            ids = self.pool[self.rng.integers(0, len(self.pool), size=k)]
            grads = self.rng.normal(size=(k, dim)).astype(np.float32)
            owner = self.plan.master_shard(ids)
            for mid in np.unique(owner):
                sel = owner == mid
                for shards in sides:
                    shards[mid].push_grad(g, ids[sel], grads[sel],
                                          step=self.step)
        self.step += 1

    def evict(self, sides, k=12):
        ids = self.pool[self.rng.integers(0, len(self.pool), size=k)]
        g = ("w", "v")[self.step % 2]
        for shards in sides:
            for m in shards:
                m.delete_rows(g, ids)

    def dense(self, sides):
        val = self.rng.normal(size=(4, 3)).astype(np.float32)
        slots = {"m": self.rng.normal(size=(4, 3)).astype(np.float32)}
        for shards in sides:
            shards[0].push_dense("mlp/w0", val.copy(),
                                 {k: v.copy() for k, v in slots.items()})


@pytest.mark.parametrize("backend", BACKENDS)
def test_snapshots_match_reference(backend):
    port, ref = _pair(2, backend)
    drv = _Driver(2, 1)
    drv.push((port, ref))
    drv.dense((port, ref))
    for p, r in zip(port, ref):
        assert_same(p.snapshot(), r.snapshot())
    marks = {m.shard_id: {g: t.version for g, t in m.tables.items()}
             for m in ref}
    dmarks = {m.shard_id: dict(m.dense.versions) for m in ref}
    drv.push((port, ref), k=40)
    drv.evict((port, ref))
    drv.push((port, ref), k=20)
    for p, r in zip(port, ref):
        d = p.delta_snapshot(marks[p.shard_id], dmarks[p.shard_id])
        assert_same(d, r.delta_snapshot(marks[r.shard_id],
                                        dmarks[r.shard_id]))
        assert 0 < len(d["tables"]["v"]["ids"]) < len(p.tables["v"])
        assert len(d["tables"]["v"]["deleted"]) + \
            len(d["tables"]["w"]["deleted"]) > 0
        assert_same(p.snapshot(), r.snapshot())
    # the snapshot of a torch table holds the host's bits, read through
    # the mirror's gather
    if backend == "torch":
        assert port[0].tables["v"].mirror_metrics()["syncs"] > 0


def _cadence(backend, compress, *, root=None, keep=8, n=4, seed=2,
             queue=False):
    """Both packages' cold backups over the same traffic: 14 ticks with a
    local interval of 1 and a remote one of 4 (the same jitter draws),
    then an explicit checkpoint and one of each tier."""
    port, ref = _pair(n, backend)
    drv = _Driver(n, seed)
    policy = dict(local_interval=1.0, remote_interval=4.0,
                  incremental=True, compress=compress)
    queues = (PartitionedQueue(3), RefQueue(3)) if queue else (None, None)
    cb = ft.ColdBackup(port, ft.CheckpointStore(
        root and f"{root}/port", keep), ft.BackupPolicy(**policy),
        queue=queues[0], rng=random.Random(7), codec_backend=backend,
        device="cpu")
    rcb = ref_ft.ColdBackup(ref, ref_ft.CheckpointStore(
        root and f"{root}/ref", keep), ref_ft.BackupPolicy(**policy),
        queue=queues[1], rng=random.Random(7), codec_backend="numpy")
    versions = []
    for tick in range(14):
        now = 0.5 * tick
        drv.push((port, ref), k=60)
        if tick % 3 == 1:
            drv.evict((port, ref))
        if tick % 5 == 2:
            drv.dense((port, ref))
        if queue:                                    # offsets move
            for q, rec in zip(queues, (Record, RefRecord)):
                q.produce(tick % 3, rec(group="w", op="upsert",
                                        ids=np.arange(2, dtype=np.int64),
                                        payload={}, seq=tick, producer=0))
        v = cb.maybe_checkpoint(now, metrics={"logloss": 0.5})
        assert v == rcb.maybe_checkpoint(now, metrics={"logloss": 0.5})
        versions.append(v)
    now = 7.5
    assert cb.checkpoint(now) == rcb.checkpoint(now)
    assert cb.checkpoint(now, tier="remote") == \
        rcb.checkpoint(now, tier="remote")
    return port, ref, cb, rcb, drv


def _compare_stores(cb, rcb):
    assert cb.store.versions() == rcb.store.versions()
    for v in rcb.store.versions():
        a, b = cb.store.load(v), rcb.store.load(v)
        for f in ("version", "created_at", "queue_offsets", "num_shards",
                  "metrics", "tier", "kind", "base"):
            assert getattr(a, f) == getattr(b, f), (v, f)
        assert_same(a.shard_snaps, b.shard_snaps, f"v{v}")
        assert ft.checkpoint_nbytes(a) == ref_ft.checkpoint_nbytes(b)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("compress", ["none", "int8"])
def test_cold_backup_chain_matches_reference(backend, compress):
    port, ref, cb, rcb, _ = _cadence(backend, compress, queue=True)
    kinds = [cb.store.load(v).kind for v in cb.store.versions()]
    assert "full" in kinds and "delta" in kinds
    _compare_stores(cb, rcb)
    assert any(cb.store.load(v).queue_offsets[0] for v in cb.store.versions())
    for v in cb.store.versions():
        got, want = cb.materialize(v), rcb.materialize(v)
        assert_same(got, want, f"materialize v{v}")
        assert_same(ft.merge_shard_tables(got["shard_snaps"]),
                    ref_ft.merge_shard_tables(want["shard_snaps"]))
        links = [c.shard_snaps for c in cb.chain(v)]
        assert_same(ft.fold_chain(links, backend, "cpu"),
                    ref_ft.fold_chain(links, "numpy"))
    # no training after the last checkpoint: its chain is the live state
    # (int8: the NumPy codec's round trip of the live rows)
    tip = cb.materialize()["shard_snaps"]
    for m in port:
        for g, t in m.tables.items():
            snap = t.snapshot()
            o = np.argsort(snap["ids"])
            rows = tip[m.shard_id]["tables"][g]
            p = np.argsort(rows["ids"])
            assert_same(rows["ids"][p], snap["ids"][o])
            for k, want in (("w", snap["w"]), *snap["slots"].items()):
                got = rows["w"] if k == "w" else rows["slots"][k]
                if compress == "int8":
                    q = ref_ft._pack_rows(want, "numpy")
                    want = q["q"].astype(np.float32) * q["scale"]
                assert_same(got[p], want[o], f"{g}.{k}")


def test_int8_blocks_match_pallas_codec():
    """The port's torch route (plain versions) against the reference's
    Pallas ``quantize_rows`` in interpret mode on one small table."""
    rng = np.random.default_rng(3)
    a = (rng.normal(size=(37, 8)) * rng.uniform(0.01, 30, (37, 1))) \
        .astype(np.float32)
    a[5] = 0.0
    want = ref_ft._pack_rows(a, "pallas")
    for backend in BACKENDS:
        got = ft._pack_rows(a, backend, "cpu")
        assert_same(got, want)
        assert_same(ft._unpack_rows(got, backend, "cpu"),
                    ref_ft._unpack_rows(want, "numpy"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_recover_shard_and_reshard_match_reference(backend):
    port, ref, cb, rcb, drv = _cadence(backend, "int8")
    # partial recovery of one shard after more traffic and a kill
    drv.push((port, ref), k=50)
    for shards in (port, ref):
        shards[1].kill()
    assert cb.recover_shard(port[1]) == rcb.recover_shard(ref[1])
    assert port[1].alive and port[1].step == ref[1].step
    for p, r in zip(port, ref):
        assert_same(p.snapshot(), r.snapshot())
    assert port[1].tables["v"].device is not None or backend == "numpy"
    # the next checkpoint is full again, on both sides
    assert cb.checkpoint(9.0) == rcb.checkpoint(9.0)
    assert cb.store.load(cb.store.latest()).kind == "full"
    # 4 → 3 reshard with the new layout's owner function
    port3, ref3 = _pair(3, backend)
    plan3, rplan3 = RoutingPlan(3, 1, 1), RefPlan(3, 1, 1)
    assert cb.recover_all(port3, owner_of=plan3.master_shard) == \
        rcb.recover_all(ref3, owner_of=rplan3.master_shard)
    total = 0
    for p, r in zip(port3, ref3):
        assert_same(p.snapshot(), r.snapshot())
        ids = p.tables["v"].all_ids()
        assert (plan3.master_shard(ids) == p.shard_id).all()
        total += len(ids)
    assert total == sum(len(m.tables["v"]) for m in port)
    with pytest.raises(ValueError, match="owner_of"):
        cb.recover_all(_pair(3, backend)[0])


@pytest.mark.parametrize("root", [False, True])
def test_store_retention_matches_reference(tmp_path, root):
    """keep=3: with a root, evicted local links are demoted to remote
    files; without one they are dropped, and deltas chained through them
    cascade-dropped — the same versions, tiers and drops on both sides."""
    r = str(tmp_path) if root else None
    _, _, cb, rcb, _ = _cadence("numpy", "none", root=r, keep=3)
    assert cb.store.dropped == rcb.store.dropped
    assert bool(cb.store.dropped) != root
    assert sorted(cb.store._remote) == sorted(rcb.store._remote)
    assert sorted(cb.store._local) == sorted(rcb.store._local)
    _compare_stores(cb, rcb)
    for v in cb.store.versions():
        assert cb.store.chain_intact(v) == rcb.store.chain_intact(v)
        assert cb.store.chain_depth(v) == rcb.store.chain_depth(v)
    with pytest.raises(KeyError):
        cb.store.load(10_000)


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_load_checkpoint_restores_reference_chain(compress):
    """A chain the JAX package wrote, carried over field by field (from
    the dataclass itself and from ``dataclasses.asdict``), restores into
    the port's masters as the reference restores it into its own."""
    _, ref, _, rcb, _ = _cadence("numpy", compress)
    store = ft.CheckpointStore()
    for i, v in enumerate(rcb.store.versions()):
        src = rcb.store.load(v)
        store.save(load_checkpoint(src if i % 2 else
                                   dataclasses.asdict(src)), tier=src.tier)
    port = _pair(4, "torch")[0]
    cb = ft.ColdBackup(port, store, ft.BackupPolicy(), codec_backend="torch",
                       device="cpu")
    fresh = [RefMaster(i, GROUPS, ref_get_optimizer("ftrl", **FTRL_KW))
             for i in range(4)]
    for m, r in zip(port, fresh):
        assert cb.recover_shard(m) == rcb.recover_shard(r)
        assert_same(m.snapshot(), r.snapshot())
    with pytest.raises(ValueError, match="lacks fields"):
        load_checkpoint({"version": 1})
    bad = dataclasses.asdict(rcb.store.load(rcb.store.latest()))
    bad["kind"] = "delta"
    with pytest.raises(ValueError, match="kind"):
        load_checkpoint(bad)


def test_errors_and_defaults():
    with pytest.raises(RuntimeError, match="no checkpoint"):
        ft.ColdBackup([], ft.CheckpointStore(), ft.BackupPolicy(),
                      device="cpu").materialize()
    with pytest.raises(ValueError, match="codec backend"):
        ft.ColdBackup([], ft.CheckpointStore(), ft.BackupPolicy(),
                      codec_backend="pallas", device="cpu")
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ft.ColdBackup([], ft.CheckpointStore(), ft.BackupPolicy())


def test_cleared_tables_free_their_mirrors_at_once():
    """A table's device mirror holds the table weakly, so the tables
    ``MasterShard.clear`` (recovery) replaces free their mirror tensors
    by refcount, with no garbage-collector pass."""
    import gc
    import weakref
    gc.disable()
    try:
        m = _pair(1, "torch")[0][0]
        m.push_grad("v", np.arange(50, dtype=np.int64),
                    np.ones((50, 8), np.float32))
        mir = m.tables["v"]._dev
        assert mir is not None and mir.arenas
        refs = [weakref.ref(mir)] + [weakref.ref(t)
                                     for t in mir.arenas.values()]
        del mir
        m.clear()
        assert all(r() is None for r in refs)
        assert m.tables["v"].device.type == "cpu" and len(m.tables["v"]) == 0
    finally:
        gc.enable()
