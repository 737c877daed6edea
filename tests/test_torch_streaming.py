"""The port's sync stream against the JAX package's, on the CPU.

The same gradient pushes go to a reference master (``numpy`` PS backend)
and a port master (``torch`` backend on ``device="cpu"``: the fused FTRL
chain through the kernels' plain versions), then through collect →
gather → push → queue → scatter on both sides. For the identity, cast16
and int8 codecs (int8 on the reference's Pallas codec in interpret mode
and on the port's torch codec) the records must be identical — ids, seq,
producer, partition and codec meta, payload bytes — and so must the
slave tables after ``poll``, the LWW skips of a replayed stream, deletes
and the ``on_apply`` calls the serving plane listens to."""

import numpy as np
import pytest

from repro.core.ps import MasterShard as RefMaster
from repro.core.ps import SlaveShard as RefSlave
from repro.core.queue import PartitionedQueue as RefQueue
from repro.core.routing import RoutingPlan as RefPlan
from repro.core import streaming as ref_st
from repro.core.transform import make_transform as ref_make_transform
from repro.optim import get_optimizer as ref_get_optimizer
from repro_torch.core import streaming as port_st
from repro_torch.core.ps import MasterShard, SlaveShard
from repro_torch.core.queue import PartitionedQueue, Record
from repro_torch.core.routing import RoutingPlan
from repro_torch.core.transform import make_transform
from repro_torch.obs import trace as port_trace
from repro_torch.optim import get_optimizer

GROUPS = {"w": 1, "v": 8}
FTRL_KW = dict(alpha=0.1, beta=1.0, l1=0.05, l2=0.2)


def _side(port: bool, codec: str, num_slave=2, parts=4):
    """One package's master → queue → slaves spine."""
    if port:
        opt = get_optimizer("ftrl", **FTRL_KW)
        master = MasterShard(0, GROUPS, opt, backend="torch", device="cpu")
        queue = PartitionedQueue(parts)
        plan = RoutingPlan(1, num_slave, parts)
        slaves = [SlaveShard(i, GROUPS, backend="torch", device="cpu",
                             codec_backend="torch")
                  for i in range(num_slave)]
        transform = make_transform(codec, opt, backend="torch",
                                   device="cpu")
        st = port_st
    else:
        opt = ref_get_optimizer("ftrl", **FTRL_KW)
        master = RefMaster(0, GROUPS, opt)
        queue = RefQueue(parts)
        plan = RefPlan(1, num_slave, parts)
        backend = "pallas" if codec == "int8" else "numpy"
        slaves = [RefSlave(i, GROUPS, codec_backend=backend)
                  for i in range(num_slave)]
        transform = ref_make_transform(codec, opt, backend=backend)
        st = ref_st
    col = st.Collector()
    master.collector = col
    applied = []
    for s in slaves:
        s.on_apply = lambda g, ids, op, sid=s.shard_id: applied.append(
            (sid, g, np.array(ids), op))
    return {"master": master, "queue": queue, "plan": plan,
            "slaves": slaves, "col": col, "applied": applied, "st": st,
            "pusher": st.Pusher(master, queue, plan, transform,
                                max_ids_per_record=16),
            "scatters": [st.Scatter(s, queue, plan) for s in slaves],
            "gatherer": st.Gatherer("realtime")}


def _tick(side, now):
    side["gatherer"].offer(side["col"].drain())
    if side["gatherer"].ready(now):
        side["pusher"].push(side["gatherer"].flush(now), now=now)
    for sc in side["scatters"]:
        sc.poll(now=now + 0.5)


def _records(queue):
    return [(p, r) for p in range(queue.num_partitions)
            for r in queue.consume(p, 0)[0]]


def _assert_same_records(port_q, ref_q):
    got, want = _records(port_q), _records(ref_q)
    assert len(got) == len(want) > 0
    for (pp, a), (rp, b) in zip(got, want):
        assert (pp, a.group, a.op, a.seq, a.producer) == \
            (rp, b.group, b.op, b.seq, b.producer)
        np.testing.assert_array_equal(a.ids, b.ids)
        assert a.meta == b.meta
        assert sorted(a.payload) == sorted(b.payload)
        for k in a.payload:
            x, y = np.asarray(a.payload[k]), np.asarray(b.payload[k])
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k
        assert a.nbytes() == b.nbytes()
    assert port_q.produced_bytes == ref_q.produced_bytes


def _assert_same_tables(port_slaves, ref_slaves):
    for ps, rs in zip(port_slaves, ref_slaves):
        assert ps.applied_records == rs.applied_records
        assert ps.skipped_records == rs.skipped_records
        for g in GROUPS:
            a, b = ps.tables[g].snapshot(), rs.tables[g].snapshot()
            oa, ob = np.argsort(a["ids"]), np.argsort(b["ids"])
            np.testing.assert_array_equal(a["ids"][oa], b["ids"][ob])
            np.testing.assert_array_equal(a["w"][oa], b["w"][ob])


@pytest.mark.parametrize("codec", ["identity", "cast16", "int8"])
def test_stream_matches_reference(codec):
    rng = np.random.default_rng({"identity": 1, "cast16": 2, "int8": 3}[codec])
    port, ref = _side(True, codec), _side(False, codec)
    pool = rng.choice(1 << 40, size=60, replace=False).astype(np.int64)
    for step in range(4):
        pushes = [(g, pool[rng.integers(0, len(pool), size=40)],
                   (rng.normal(size=(40, dim)) * 2).astype(np.float32))
                  for g, dim in GROUPS.items()]
        for side in (port, ref):
            for g, ids, grads in pushes:
                side["master"].push_grad(g, ids, grads, step=step)
            _tick(side, float(step))
    doomed = pool[:5]
    for side in (port, ref):                       # a streamed delete
        side["master"].delete_rows("v", doomed)
        _tick(side, 9.0)
    _assert_same_records(port["queue"], ref["queue"])
    _assert_same_tables(port["slaves"], ref["slaves"])
    assert port["master"].fused_batches == 8
    for (a, b) in zip(port["applied"], ref["applied"]):
        assert a[0] == b[0] and a[1:2] == b[1:2] and a[3] == b[3]
        np.testing.assert_array_equal(a[2], b[2])
    assert len(port["applied"]) == len(ref["applied"]) > 0
    assert any(op == "delete" for *_, op in port["applied"])
    for s in port["slaves"]:
        np.testing.assert_array_equal(s.lookup("v", doomed),
                                      np.zeros((5, 8), np.float32))
    # at-least-once redelivery: a replay from offset 0 skips every stale
    # record and rewrites nothing, on both sides alike
    for side in (port, ref):
        for s in side["slaves"]:
            side["st"].Scatter(s, side["queue"], side["plan"], offsets={
                p: 0 for p in range(side["queue"].num_partitions)}).poll()
    _assert_same_tables(port["slaves"], ref["slaves"])
    assert sum(s.skipped_records for s in port["slaves"]) > 0
    for a, b in zip(port["scatters"], ref["scatters"]):
        assert a.applied == b.applied and a.offsets() == b.offsets()
        np.testing.assert_array_equal(a.staleness.values(),
                                      b.staleness.values())


def test_gather_modes_and_dedup():
    g = port_st.Gatherer("threshold", threshold=5)
    g.offer([("w", np.array([1, 2, 3]), "upsert")])
    assert not g.ready(0.0)
    g.offer([("w", np.array([4, 5]), "upsert")])
    assert g.ready(0.0)
    g = port_st.Gatherer("period", period=10.0)
    g.offer([("w", np.array([1]), "upsert")])
    assert not g.ready(5.0) and g.ready(10.0)
    g = port_st.Gatherer("period", period=1.0)
    for _ in range(10):
        g.offer([("w", np.array([1, 2, 3, 4]), "upsert")])
    assert len(g.flush(1.0)[("w", "upsert")]) == 4
    assert g.stats.dedup_ratio == pytest.approx(0.9)
    with pytest.raises(ValueError):
        port_st.Gatherer("sometimes")


def test_batched_scatter_lww_and_delete_ordering():
    """Overlapping ids inside one poll resolve by arrival order; a stale
    redelivery is skipped; a delete after an upsert in one poll wins."""
    plan, queue = RoutingPlan(1, 1, 1), PartitionedQueue(1)
    slave = SlaveShard(0, {"w": 4}, backend="torch", device="cpu")
    sc = port_st.Scatter(slave, queue, plan)
    ids = np.array([5, 6], np.int64)

    def rec(seq, fill, op="upsert"):
        return Record(group="w", op=op, ids=ids,
                      payload={} if op == "delete" else
                      {"values": np.full((2, 4), fill, np.float32)},
                      seq=seq, producer=0, meta={"codec": "identity"})

    queue.produce(0, rec(0, 1.0))
    queue.produce(0, rec(1, 2.0))
    assert sc.poll() == 2
    np.testing.assert_array_equal(slave.lookup("w", ids),
                                  np.full((2, 4), 2.0, np.float32))
    queue.produce(0, rec(0, 1.0))                      # stale redelivery
    assert sc.poll() == 0 and slave.skipped_records == 1
    queue.produce(0, rec(2, 3.0))
    queue.produce(0, rec(3, 0.0, op="delete"))
    assert sc.poll() == 2
    assert len(slave.tables["w"]) == 0
    slave.kill()
    with pytest.raises(RuntimeError):
        slave.apply(rec(4, 1.0))


def test_sync_pipeline_and_trace_spans():
    """``SyncPipeline`` keeps each slave's own decode backend, and with the
    tracer on a flush shows as sync.push → sync.queue → sync.apply."""
    opt = get_optimizer("ftrl", **FTRL_KW)
    master = MasterShard(0, {"w": 4}, opt, backend="torch", device="cpu")
    slave = SlaveShard(0, {"w": 4}, backend="torch", device="cpu",
                       codec_backend="numpy")
    pipe = port_st.SyncPipeline(
        master, [slave], PartitionedQueue(2), RoutingPlan(1, 1, 2),
        make_transform("int8", opt, backend="torch", device="cpu"))
    assert slave.codec_backend == "numpy"
    tr = port_trace.configure(enabled=True)
    try:
        master.push_grad("w", np.arange(10, dtype=np.int64),
                         np.ones((10, 4), np.float32))
        assert pipe.tick(0.0) > 0
        names = {s["name"] for s in tr.export()}
    finally:
        port_trace.disable()
    assert {"sync.push", "sync.queue", "sync.apply"} <= names
    m = pipe.metrics(1.0)
    assert m.pushed_bytes > 0 and m.records_in_flight == 0
    w, slots = master.tables["w"].gather(np.arange(10, dtype=np.int64))
    serve = pipe.pusher.transform.serve_values(w, slots)
    step = np.abs(serve).max(axis=1, keepdims=True) / 127
    assert (np.abs(slave.lookup("w", np.arange(10, dtype=np.int64))
                   - serve) <= step / 2 + 1e-7).all()
