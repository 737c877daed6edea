"""The port's kernel entry points against the JAX package's, on the CPU,
where the port's wrappers run the plain versions and the reference's
Pallas kernels run in interpret mode (the CUDA kernels themselves are
held against their plain versions in ``tests/test_torch_cuda.py``).

Gather and scatter are row copies, so bit-equality is the contract for
every row width the serve path uses: D = 1 (LR ``w``), 8 (FM ``v``) and
9 (the serve cache's combined row)."""

import numpy as np
import pytest
import torch

from repro.core.hashmap import IdHashMap
from repro.kernels import ops as ref_ops
from repro_torch.kernels import embedding_lookup as port_el
from repro_torch.kernels import hashmap_probe as port_hm
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import ref as port_ref


@pytest.mark.parametrize("d", [1, 8, 9])
def test_embedding_lookup_matches_reference(d):
    rng = np.random.default_rng(d)
    table = rng.normal(size=(48, d)).astype(np.float32)
    ids = rng.integers(0, 48, size=24).astype(np.int32)
    want = np.asarray(ref_ops.embedding_lookup(table, ids))
    got = port_ops.embedding_lookup(torch.from_numpy(table),
                                    torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", [1, 8, 9])
def test_embedding_scatter_matches_reference(d):
    rng = np.random.default_rng(10 + d)
    table = rng.normal(size=(48, d)).astype(np.float32)
    ids = rng.permutation(48)[:20].astype(np.int32)
    upd = rng.normal(size=(20, d)).astype(np.float32)
    want = np.asarray(ref_ops.embedding_scatter(table, ids, upd))
    t = torch.from_numpy(table.copy())
    got = port_ops.embedding_scatter(t, torch.from_numpy(ids),
                                     torch.from_numpy(upd))
    assert got is t                          # in place, as documented
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype,d,where,plan", [
    (torch.float32, 1, None, (4, 1, False)),      # compile-time widths
    (torch.float32, 9, None, (4, 9, False)),
    (torch.float32, 8, None, (16, 2, False)),
    (torch.float32, 2, None, (8, 1, False)),      # run-time narrow widths
    (torch.float32, 3, None, (4, 3, False)),
    (torch.float32, 64, None, (16, 16, False)),
    (torch.float32, 124, None, (16, 31, False)),
    (torch.float32, 128, None, (16, 32, True)),   # the first wide width
    (torch.bfloat16, 1536, None, (16, 192, True)),
    (torch.bfloat16, 1537, None, (2, 1537, True)),
    (torch.uint8, 7, None, (1, 7, False)),
    (torch.uint8, 101, None, (1, 101, True)),
    (torch.float32, 8, "table", (4, 8, False)),   # a pointer off 16 bytes
    (torch.float32, 8, "rows", (4, 8, False)),
    (torch.bfloat16, 1536, "table", (2, 1536, True)),
])
def test_copy_plan(dtype, d, where, plan):
    """The copy kernels' plan: the widest word dividing both pointers
    and the row's bytes, the words a row, and wide rows from 32 words."""
    def view(n, off):
        return torch.zeros(n * d + off, dtype=dtype)[off:].view(n, d)
    table = view(64, int(where == "table"))
    rows = view(5, int(where == "rows"))
    assert port_el.copy_plan(table, rows) == plan


@pytest.mark.parametrize("placement", ["auto", "vmem", "hbm"])
def test_fused_lookup_matches_reference(placement):
    """Rows, found mask and arena slots of probe → slot translate →
    gather, against the reference's fused chain — zeros and slot 0 at
    misses, tombstoned and sentinel ids included."""
    rng = np.random.default_rng(7)
    m = IdHashMap(16)
    ids = rng.choice(1 << 40, size=300, replace=False).astype(np.int64)
    m.put(ids, rng.permutation(400)[:300])
    m.delete(ids[:30])
    arena = rng.normal(size=(400, 9)).astype(np.float32)
    slot_of = m.val_table.astype(np.int32)
    qs = np.concatenate([ids, ids[:8] + 1,
                         np.array([-2 ** 63, -2 ** 63 + 1], np.int64)])
    klo, khi = ref_ops.int64_limbs(m.key_table)
    qlo, qhi = ref_ops.int64_limbs(qs)
    r_rows, r_found, r_slot = ref_ops.fused_lookup(
        klo, khi, slot_of, arena, qlo, qhi, shift=int(m.shift),
        placement=placement)
    keys = torch.from_numpy(m.key_table.copy())
    if port_ops.resolve_placement(m.shift, placement) == "hbm":
        keys = port_hm.wrap_pad(keys, cap=m.capacity)
    rows, found, slot = port_ops.fused_lookup(
        keys, torch.from_numpy(slot_of), torch.from_numpy(arena),
        torch.from_numpy(qs), shift=int(m.shift), placement=placement)
    np.testing.assert_array_equal(found.numpy(), np.asarray(r_found))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(r_slot))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(r_rows))
    assert found.numpy()[30:300].all() and not found.numpy()[:30].any()


def test_placement_routing_matches_reference():
    """``auto`` routes on the same capacity bound as the reference."""
    from repro.kernels.hashmap_probe import VMEM_SLOT_BOUND as REF_BOUND
    assert port_hm.VMEM_SLOT_BOUND == REF_BOUND
    assert port_hm._WINDOW == 8 and port_hm._DMA_WINDOW == 256
    for cap_pow, want in ((4, "vmem"), (21, "vmem"), (22, "hbm")):
        assert port_ops.resolve_placement(64 - cap_pow) == want
    with pytest.raises(ValueError):
        port_ops.resolve_placement(40, "sram")


def test_wrappers_reject_bad_inputs_without_assert():
    """Kernel wrappers raise ValueError — never AssertionError, which
    ``ReplicaSet.read`` would take for a dead replica. A key table not in
    the placement's exact layout is one such input."""
    keys = torch.full((16,), -2 ** 63, dtype=torch.int64)
    q = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError):
        port_hm.hashmap_probe_hbm(keys[:10], q, shift=60)
    with pytest.raises(ValueError):
        port_hm.hashmap_probe_hbm(keys, q, shift=60)      # not wrap-padded
    with pytest.raises(ValueError):
        port_hm.hashmap_probe(port_hm.wrap_pad(keys, cap=16), q, shift=60)
    with pytest.raises(ValueError):
        port_el.embedding_lookup(torch.zeros(4, 2),
                                 torch.zeros(2, dtype=torch.int32).to("meta"))


def test_empty_batches():
    keys = torch.full((16,), -2 ** 63, dtype=torch.int64)
    for placement, table in (("vmem", keys),
                             ("hbm", port_hm.wrap_pad(keys, cap=16))):
        pos, found = port_ops.hashmap_probe(
            table, torch.zeros(0, dtype=torch.int64), shift=60,
            placement=placement)
        assert pos.shape == (0,) and found.shape == (0,)
    rows = port_ops.embedding_lookup(torch.zeros(4, 9),
                                     torch.zeros(0, dtype=torch.int32))
    assert rows.shape == (0, 9)
