"""The port's ``SparseTable`` device mirror against the JAX package's.

A port table (``backend="torch"``, ``device="cpu"``: the mirror runs
the kernels' plain versions) and a reference table (``backend="pallas"``,
interpret mode) go through the same ensure / insert_rows / evict / reset
/ grow sequence. At every step their ``gather`` and ``lookup_device``
results must be bit-equal and their ``mirror_metrics()`` counters equal:
syncs, full and incremental key uploads, key bytes and arena bytes —
which pins the incremental key sync (dirty-slot journal, wrap-pad
mirror region) and the arena resync (scatter vs bulk) to the
reference's decisions."""

import numpy as np
import pytest

from repro.core.ps import SparseTable as RefTable
from repro_torch.core.ps import SparseTable as PortTable


def _ids(rng, n):
    return rng.choice(1 << 40, size=n, replace=False).astype(np.int64)


def _compare(port, ref, q):
    pw, _ = port.gather(q)
    rw, _ = ref.gather(q)
    np.testing.assert_array_equal(pw, rw)
    p_rows, p_found, p_slot = port.lookup_device(q)
    r_rows, r_found, r_slot = ref.lookup_device(q)
    np.testing.assert_array_equal(p_rows.numpy(), np.asarray(r_rows))
    np.testing.assert_array_equal(p_found, r_found)
    np.testing.assert_array_equal(p_slot, r_slot)
    assert port.mirror_metrics() == ref.mirror_metrics()


@pytest.mark.parametrize("dim,placement", [(9, "auto"), (1, "hbm")])
def test_sparse_table_mirror_matches_reference(dim, placement):
    rng = np.random.default_rng(dim)
    port = PortTable(dim, backend="torch", device="cpu")
    ref = RefTable(dim, backend="pallas")
    for t in (port, ref):
        t.device_placement = placement
    ids = _ids(rng, 1400)
    w = rng.normal(size=(1400, dim)).astype(np.float32)
    absent = _ids(rng, 8) + (1 << 41)

    def step(fn):
        for t in (port, ref):
            fn(t)
        q = np.concatenate([rng.choice(ids, 40), absent])
        _compare(port, ref, q)

    step(lambda t: t.scatter(ids[:200], w[:200]))           # ensure + write
    step(lambda t: t.insert_rows(ids[200:220], w[200:220]))  # scatter resync
    step(lambda t: t.evict(ids[:10]))                       # tombstones
    step(lambda t: t.scatter(ids[:5], w[300:305]))          # reuse freed
    step(lambda t: t.reset())                               # map cleared
    step(lambda t: t.insert_rows(ids[:60], w[:60]))
    step(lambda t: t.insert_rows(ids[60:1400], w[60:1400]))  # arena + map grow
    m = port.mirror_metrics()
    assert m["key_incremental_uploads"] > 0 and m["key_full_uploads"] > 1
    assert m["placement"] == ("hbm" if placement == "hbm" else "vmem")


def test_mirror_scatter_resync_counts_rows():
    """A handful of dirty rows re-upload through the scatter, counted
    per row — the path ``chip_smoke.py`` drives on the card."""
    rng = np.random.default_rng(3)
    t = PortTable(9, backend="torch", device="cpu")
    ids = _ids(rng, 300)
    t.insert_rows(ids[:200], rng.normal(size=(200, 9)).astype(np.float32))
    t.lookup_device(ids[:4])
    before = t.mirror_metrics()["arena_bytes_uploaded"]
    t.insert_rows(ids[200:210], rng.normal(size=(10, 9)).astype(np.float32))
    rows, found, _ = t.lookup_device(ids[195:210])
    assert found.all()
    np.testing.assert_array_equal(rows.numpy(), t.gather(ids[195:210])[0])
    assert t.mirror_metrics()["arena_bytes_uploaded"] - before == 10 * 9 * 4


def test_device_must_exist_and_backend_is_checked():
    import torch
    with pytest.raises(ValueError):
        PortTable(4, backend="pallas", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PortTable(4, backend="torch", device="cuda")
    PortTable(4, backend="numpy", device="cuda")    # host path: no device


def test_slave_replica_lifecycle_matches_reference():
    """The serving half of ``SlaveShard`` and ``ReplicaSet`` against the
    reference: lookups (missing rows zeros), a peer-copied replica
    (``full_sync_from`` via ``add_replica``), kill/revive and the
    failover read, and ``add_group``."""
    from repro.core.fault_tolerance import ReplicaSet as RefSet
    from repro.core.ps import SlaveShard as RefSlave
    from repro_torch.core.fault_tolerance import ReplicaSet as PortSet
    from repro_torch.core.ps import SlaveShard as PortSlave

    rng = np.random.default_rng(9)
    groups = {"w": 1, "v": 8}
    ids = _ids(rng, 64)
    rows = {g: rng.normal(size=(64, d)).astype(np.float32)
            for g, d in groups.items()}
    ref_set = RefSet([RefSlave(0, groups, backend="pallas")])
    port_set = PortSet([PortSlave(0, groups, backend="torch", device="cpu")])
    for rs in (ref_set, port_set):
        for g in groups:
            rs.replicas[0].tables[g].scatter(ids, rows[g])
    ref_set.add_replica(RefSlave(0, groups, backend="pallas"))
    port_set.add_replica(PortSlave(0, groups, backend="torch", device="cpu"))
    q = np.concatenate([ids[::3], _ids(rng, 5) + (1 << 41)])
    for g in groups:
        for r in range(2):
            np.testing.assert_array_equal(
                port_set.replicas[r].lookup(g, q),
                ref_set.replicas[r].lookup(g, q))
    for rs in (ref_set, port_set):
        rs.replicas[0].kill()
    for g in groups:
        np.testing.assert_array_equal(port_set.lookup(g, q),
                                      ref_set.lookup(g, q))
    with pytest.raises(AssertionError):           # the failover signal
        port_set.replicas[0].lookup("w", q)
    port_set.replicas[0].revive()
    np.testing.assert_array_equal(port_set.replicas[0].lookup("w", q),
                                  ref_set.replicas[1].lookup("w", q))
    shard = port_set.replicas[1]
    shard.add_group("w", 1)                         # idempotent
    shard.add_group("emb", 4)
    assert (shard.lookup("emb", q) == 0).all()
    with pytest.raises(ValueError):
        shard.add_group("v", 3)
