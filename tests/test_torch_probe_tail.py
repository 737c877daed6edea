"""The order in which ``hashmap_probe_hbm``'s CUDA kernel resolves an id,
emulated in PyTorch on the CPU and held against the host map
``IdHashMap._probe`` and the plain version ``ref.hashmap_probe_hbm``, and
against the JAX package's map and its ``ops.hashmap_probe`` (placement
"hbm", the Pallas kernel in interpret mode) on the same inputs.

The kernel (``csrc/hashmap_probe.cu``, ``probe_hbm_kernel``) cannot run
here, so its order is pinned by an emulation: the home slot; then the
host's first 8-slot group from ``home + 1`` alone; then 32-slot steps
(four host groups) from the next group, offsets folded through
``& (cap - 1)``, where the lowest group holding a hit or an EMPTY decides
and a hit in it beats an EMPTY in it; at most the host walk's
``cap / 8 + 2`` groups.

The map cases live here, built on the port's ``IdHashMap`` (bit-equal to
the reference's, ``tests/test_torch_hashmap.py``), so the card's tests
(``tests/test_torch_cuda.py``, which import nothing of JAX) use them too;
the JAX package is imported only inside the tests that need it.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import hashmap as port_hashmap
from repro_torch.kernels import ref

STEP = 32                       # slots a warp step reads: four host groups


def probe_case(mod, cap_pow, n_ids, n_del, seed):
    """A ``mod.IdHashMap`` with live keys, tombstones and a grown
    capacity, and queries mixing hits / misses / deleted ids / sentinels
    (the reference's own kernel-test recipe)."""
    rng = np.random.default_rng(seed)
    m = mod.IdHashMap(16)
    ids = rng.choice(1 << 40, size=n_ids, replace=False).astype(np.int64)
    m.put(ids, np.arange(n_ids))
    if n_del:
        m.delete(ids[:n_del])
    assert m.capacity == 1 << cap_pow
    absent = rng.choice(1 << 40, size=64, replace=False).astype(np.int64)
    absent = absent[~np.isin(absent, ids)]
    qs = np.concatenate([ids[n_del:], ids[:n_del], absent,
                         np.array([mod.EMPTY, mod.TOMB, 0, -1], np.int64)])
    return m, qs


def chain_case(mod):
    """One collision cluster longer than the 16-slot windowed pass: ids
    whose home slots share a 4-slot neighbourhood pile into one run, so
    the walk crosses window boundaries (the reference's recipe)."""
    rng = np.random.default_rng(5)
    m = mod.IdHashMap(1024)
    cand = rng.choice(1 << 40, size=200_000, replace=False).astype(np.int64)
    homes = mod.home_slots(cand, m.shift)
    cluster = cand[(homes >= 100) & (homes < 104)][:48]
    spread = cand[homes % 7 == 0][:120]
    m.put(np.unique(np.concatenate([cluster, spread])), np.arange(168))
    assert m.capacity == 1024
    absent = cand[~np.isin(cand, cluster) & (homes >= 100)
                  & (homes < 104)][:16]
    return m, np.concatenate([cluster, absent, spread[:8]])


def full_case(cap, seed, mod=port_hashmap):
    """A hand-built ``mod.IdHashMap`` table with no EMPTY slot: every
    slot live or TOMB, so a walk ends only at its bound. Returns the map,
    its live keys (found where they lie, however far from home) and
    queries that are not in it: absent ids and sentinels (the host map
    raises on an absent id here, "did not terminate"; the plain version
    ends as not found)."""
    rng = np.random.default_rng(seed)
    m = mod.IdHashMap(cap)
    keys = rng.choice(1 << 40, size=cap, replace=False).astype(np.int64)
    keys[rng.random(cap) < 0.25] = mod.TOMB
    m._keys[:] = keys
    live = keys[keys > mod.TOMB]
    absent = rng.choice(1 << 40, size=32, replace=False).astype(np.int64)
    absent = absent[~np.isin(absent, keys)]
    return m, live, np.concatenate([absent, np.array(
        [mod.EMPTY, mod.TOMB], np.int64)])


def gap_case(mod, cap=64, home=60):
    """A hand-built table whose groups hold an EMPTY before a hit: the
    host's window takes the hit, so the kernel's groups must too. A run
    of fillers from ``home``, an EMPTY at ``home + 10``, then Z (home
    ``home + 3``: an EMPTY and Z in its first group), X (home ``home``: an
    EMPTY and X in its second group) and Y (home ``home``, past X's
    deciding group: not found). The run wraps past slot ``cap - 1``."""
    rng = np.random.default_rng(9)
    m = mod.IdHashMap(cap)
    cand = rng.choice(1 << 40, size=20_000, replace=False).astype(np.int64)
    homes = mod.home_slots(cand, m.shift)
    x, y = cand[homes == home][:2]
    z = cand[homes == (home + 3) % cap][0]
    filler = cand[:12]
    keys = np.full(cap, mod.EMPTY, np.int64)
    for off, k in [(j, filler[j]) for j in range(10)] + [
            (11, z), (12, x), (13, filler[10]), (20, y), (21, filler[11])]:
        keys[(home + off) % cap] = k
    m._keys[:] = keys
    absent = cand[homes == home][2:6]
    return m, np.concatenate([[x, y, z], filler, absent])


PROBE_CASES = [(4, 3, 1), (8, 60, 10), (10, 200, 40), (12, 1000, 200)]


def cases(mod=port_hashmap):
    """``{name: (map, queries)}``: every ``PROBE_CASES`` size (cap = 16,
    whose wrap pad is shorter than a 32-slot read, included), the chain
    case and the gap case."""
    out = {f"cap2^{c[0]}": probe_case(mod, *c, seed=17 + c[0])
           for c in PROBE_CASES}
    out["chain"] = chain_case(mod)
    out["gap"] = gap_case(mod)
    return out


def emulate(keys: torch.Tensor, ids: torch.Tensor,
            shift: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``probe_hbm_kernel``'s order, id by id (lanes of a warp resolve
    independently; a step shared by lanes at one ``cur`` reads the same
    slots for each). ``keys`` is the exact-capacity table: the kernel
    reads no pad."""
    cap = 1 << (64 - shift)
    imask = cap - 1
    bad = ids <= ref.TOMB
    home = ref.home_slots(torch.where(bad, torch.zeros_like(ids), ids), shift)
    k = keys[home]
    found = (k == ids) & ~bad
    pos = home.clone()
    open_ = ~bad & ~found & (k != ref.EMPTY)
    cur = (home + 1) & imask
    idx = open_.nonzero().squeeze(1)            # the lane group
    cand = (cur[idx, None] + torch.arange(8)) & imask
    kw = keys[cand]
    hitw = kw == ids[idx, None]
    hit = hitw.any(dim=1)
    first = hitw.to(torch.uint8).argmax(dim=1)
    pos[idx[hit]] = cand[hit, first[hit]]
    found[idx[hit]] = True
    open_[idx] = ~hit & ~(kw == ref.EMPTY).any(dim=1)
    cur = (cur + 8) & imask
    groups = cap // 8 + 1                       # host groups left
    idx = open_.nonzero().squeeze(1)
    c = cur[idx]
    grp = torch.arange(STEP) // 8
    for _ in range(-(-groups // (STEP // 8))):
        if idx.numel() == 0:
            break
        cand = (c[:, None] + torch.arange(STEP)) & imask
        kw = keys[cand]
        hitw = kw == ids[idx, None]
        gmin = torch.where(hitw | (kw == ref.EMPTY), grp, STEP).min(dim=1)
        hit_in = hitw & (grp == gmin.values[:, None])
        fnd = hit_in.any(dim=1)
        first = hit_in.to(torch.uint8).argmax(dim=1)
        pos[idx[fnd]] = cand[fnd, first[fnd]]
        found[idx[fnd]] = True
        keep = gmin.values == STEP
        idx, c = idx[keep], (c[keep] + STEP) & imask
    return pos.to(torch.int32), found


@pytest.mark.parametrize("name", list(cases()))
def test_kernel_order_matches_host_map_and_plain(name):
    m, qs = cases()[name]
    keys = torch.from_numpy(m.key_table.copy())
    q = torch.from_numpy(qs)
    pos, found = emulate(keys, q, int(m.shift))
    h_pos, h_found = m._probe(qs)
    np.testing.assert_array_equal(found.numpy(), h_found)
    np.testing.assert_array_equal(pos.numpy()[h_found], h_pos[h_found])
    p_pos, p_found = ref.hashmap_probe_hbm(
        ref.wrap_pad(keys, cap=m.capacity), q, shift=int(m.shift))
    assert torch.equal(found, p_found)
    assert torch.equal(pos, p_pos)        # home where not found, 0 for
    assert not found[qs <= ref.TOMB].any()  # sentinels
    assert (pos[torch.from_numpy(qs <= ref.TOMB)] == 0).all()
    if name == "gap":                       # X and Z found, Y not
        assert found[:3].tolist() == [True, False, True]


@pytest.mark.parametrize("cap", [16, 64])
def test_kernel_order_walks_a_full_table_to_its_bound(cap):
    """No EMPTY slot: each live key is found where the host map finds it
    (the walk reaches every slot within the host's bound), ids not in the
    table end as not found as in the plain version, and a table of TOMBs
    only finds nothing."""
    m, live, absent = full_case(cap, cap)
    keys = torch.from_numpy(m.key_table.copy())
    shift = int(m.shift)
    pos, found = emulate(keys, torch.from_numpy(live), shift)
    h_pos, h_found = m._probe(live)
    assert found.all() and h_found.all()
    np.testing.assert_array_equal(pos.numpy(), h_pos)
    q = torch.from_numpy(np.concatenate([live, absent]))
    pos, found = emulate(keys, q, shift)
    p_pos, p_found = ref.hashmap_probe_hbm(ref.wrap_pad(keys, cap=cap), q,
                                           shift=shift)
    assert torch.equal(found, p_found) and torch.equal(pos, p_pos)
    assert not found[len(live):].any()
    tombs = torch.full((cap,), int(ref.TOMB), dtype=torch.int64)
    _, none = emulate(tombs, torch.from_numpy(live), shift)
    assert not none.any()


def _reference_hbm(m, qs):
    """The JAX package's hbm probe (the Pallas kernel, interpret mode on
    the CPU) of the ids ``qs`` against the reference map ``m``."""
    from repro.kernels import ops as ref_ops
    klo, khi = ref_ops.int64_limbs(m.key_table)
    qlo, qhi = ref_ops.int64_limbs(qs)
    pos, found = ref_ops.hashmap_probe(klo, khi, qlo, qhi,
                                       shift=int(m.shift), placement="hbm")
    return np.asarray(pos), np.asarray(found)


def _held_to_reference(m, qs, host):
    """The emulation and the port's plain version on the reference map's
    keys, against the reference's hbm probe (``found`` everywhere, ``pos``
    where found) and, on the ids ``host`` selects, its host map."""
    keys = torch.from_numpy(m.key_table.copy())
    q = torch.from_numpy(qs)
    shift = int(m.shift)
    r_pos, r_found = _reference_hbm(m, qs)
    p_pos, p_found = ref.hashmap_probe_hbm(
        ref.wrap_pad(keys, cap=m.capacity), q, shift=shift)
    e_pos, e_found = emulate(keys, q, shift)
    for pos, found in ((e_pos.numpy(), e_found.numpy()),
                       (p_pos.numpy(), p_found.numpy())):
        np.testing.assert_array_equal(found, r_found)
        np.testing.assert_array_equal(pos[found], r_pos[r_found])
    h_pos, h_found = m._probe(qs[host])
    np.testing.assert_array_equal(e_found.numpy()[host], h_found)
    np.testing.assert_array_equal(e_pos.numpy()[host][h_found],
                                  h_pos[h_found])
    return e_found.numpy()


@pytest.mark.parametrize("name", list(cases()))
def test_kernel_order_matches_jax_package(name):
    """The same cases built on the JAX package's map: the gap case pins
    the rule that a hit beats an EMPTY in its group to the reference's
    kernel and host map, not to the port alone."""
    from repro.core import hashmap as ref_hashmap
    m, qs = cases(ref_hashmap)[name]
    found = _held_to_reference(m, qs, np.ones(len(qs), bool))
    if name == "gap":                       # X and Z found, Y not
        assert found[:3].tolist() == [True, False, True]


@pytest.mark.parametrize("cap", [16, 64])
def test_full_table_matches_jax_package(cap):
    """A table with no EMPTY slot built on the JAX package's map: the
    reference's hbm probe, the emulation and the port's plain version
    agree on its live keys and on ids not in it (ends at cap / 8 + 2
    groups, not found), and its host map on the live keys."""
    from repro.core import hashmap as ref_hashmap
    m, live, absent = full_case(cap, cap, ref_hashmap)
    qs = np.concatenate([live, absent])
    found = _held_to_reference(m, qs, np.arange(len(qs)) < len(live))
    assert found[:len(live)].all() and not found[len(live):].any()
    m._keys[:] = ref_hashmap.TOMB           # TOMBs only: nothing found
    assert not _held_to_reference(m, live, np.zeros(len(live), bool)).any()
