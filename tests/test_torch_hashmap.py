"""The port's hash map and plain probes against the JAX package.

``repro_torch.core.hashmap.IdHashMap`` is the host oracle of the port's
probe kernels, so it must stay the reference's map step for step: same
key/value tables, same probe results, same dirty-slot journal after the
same insert/delete/grow/clear sequence. The port's plain probes (the
in-place walk and the windowed pass structure) must equal the
reference's ``ops.hashmap_probe`` (Pallas, interpret mode on the CPU)
for both placements wherever found — bit-equal, including tombstones,
sentinel queries and collision chains that cross a probe window."""

import numpy as np
import pytest
import torch

from repro.core import hashmap as ref_hashmap
from repro.kernels import ops as ref_ops
from repro_torch.core import hashmap as port_hashmap
from repro_torch.kernels import ref as port_ref


def _drive(mod, seed):
    """One insert/put/delete/grow/clear sequence on ``mod.IdHashMap``;
    returns the map and the journal answers read along the way."""
    rng = np.random.default_rng(seed)
    m = mod.IdHashMap(16)
    m.track_dirty_slots()
    answers = []
    ids = rng.choice(1 << 40, size=300, replace=False).astype(np.int64) - 7
    m.put(ids[:5], np.arange(5))                      # 16 slots
    v0 = m.version
    m.put(ids[3:9], np.arange(100, 106))              # rewrite + insert
    answers.append(m.dirty_slots_since(v0))
    m.delete(ids[:2])                                 # tombstones
    answers.append(m.dirty_slots_since(v0))
    m.insert(ids[9:200], np.arange(9, 200))           # grows past 2^8
    v1 = m.version
    m.delete(ids[50:90])
    m.put(ids[200:230], np.arange(200, 230))          # reuses tombstones
    answers.append(m.dirty_slots_since(v1))
    m.trim_dirty_log(m.version)
    answers.append(m.dirty_slots_since(v1))
    return m, answers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_idhashmap_matches_reference(seed):
    ref_m, ref_ans = _drive(ref_hashmap, seed)
    port_m, port_ans = _drive(port_hashmap, seed)
    np.testing.assert_array_equal(port_m.key_table, ref_m.key_table)
    np.testing.assert_array_equal(port_m.val_table, ref_m.val_table)
    assert (port_m.capacity, len(port_m), port_m.version) == \
        (ref_m.capacity, len(ref_m), ref_m.version)
    for a, b in zip(port_ans, ref_ans):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(seed + 10)
    qs = np.concatenate([ref_m.keys(), rng.integers(-2 ** 62, 2 ** 62, 50),
                         np.array([ref_hashmap.EMPTY, ref_hashmap.TOMB])])
    p_pos, p_found = port_m._probe(qs)
    r_pos, r_found = ref_m._probe(qs)
    np.testing.assert_array_equal(p_found, r_found)
    np.testing.assert_array_equal(p_pos[p_found], r_pos[r_found])
    m2 = port_hashmap.IdHashMap(16)
    m2.put(qs[:10], np.arange(10))
    m2.clear()
    assert len(m2) == 0 and m2.dirty_slots_since(0) is None


def _probe_case(cap_pow, n_ids, n_del, seed):
    """A reference host map with live keys, tombstones and a grown
    capacity, and queries mixing hits / misses / deleted ids / sentinels
    (the reference's own kernel-test recipe)."""
    rng = np.random.default_rng(seed)
    m = ref_hashmap.IdHashMap(16)
    ids = rng.choice(1 << 40, size=n_ids, replace=False).astype(np.int64)
    m.put(ids, np.arange(n_ids))
    if n_del:
        m.delete(ids[:n_del])
    assert m.capacity == 1 << cap_pow
    absent = rng.choice(1 << 40, size=64, replace=False).astype(np.int64)
    absent = absent[~np.isin(absent, ids)]
    qs = np.concatenate([ids[n_del:], ids[:n_del], absent,
                         np.array([ref_hashmap.EMPTY, ref_hashmap.TOMB, 0, -1],
                                  np.int64)])
    return m, qs


def _chain_case():
    """One collision cluster longer than the 16-slot windowed pass: ids
    whose home slots share a 4-slot neighbourhood pile into one run, so
    the walk crosses window boundaries (the reference's recipe)."""
    rng = np.random.default_rng(5)
    m = ref_hashmap.IdHashMap(1024)
    cand = rng.choice(1 << 40, size=200_000, replace=False).astype(np.int64)
    homes = ref_hashmap.home_slots(cand, m.shift)
    cluster = cand[(homes >= 100) & (homes < 104)][:48]
    spread = cand[homes % 7 == 0][:120]
    m.put(np.unique(np.concatenate([cluster, spread])), np.arange(168))
    assert m.capacity == 1024
    absent = cand[~np.isin(cand, cluster) & (homes >= 100)
                  & (homes < 104)][:16]
    return m, np.concatenate([cluster, absent, spread[:8]])


PROBE_CASES = [(4, 3, 1), (8, 60, 10), (10, 200, 40), (12, 1000, 200)]


@pytest.mark.parametrize("placement", ["vmem", "hbm"])
@pytest.mark.parametrize("case", PROBE_CASES + ["chain"])
def test_plain_probe_matches_reference(case, placement):
    if case == "chain":
        m, qs = _chain_case()
    else:
        m, qs = _probe_case(*case, seed=17 + case[0])
    klo, khi = ref_ops.int64_limbs(m.key_table)
    qlo, qhi = ref_ops.int64_limbs(qs)
    r_pos, r_found = ref_ops.hashmap_probe(klo, khi, qlo, qhi,
                                           shift=int(m.shift),
                                           placement=placement)
    r_pos, r_found = np.asarray(r_pos), np.asarray(r_found)
    keys = torch.from_numpy(m.key_table.copy())
    if placement == "vmem":
        plain = port_ref.hashmap_probe
    else:
        plain = port_ref.hashmap_probe_hbm
        keys = port_ref.wrap_pad(keys, cap=m.capacity)
    pos, found = plain(keys, torch.from_numpy(qs), shift=int(m.shift))
    pos, found = pos.numpy(), found.numpy()
    np.testing.assert_array_equal(found, r_found)
    np.testing.assert_array_equal(pos[found], r_pos[r_found])
    h_pos, h_found = m._probe(qs)                 # and the host oracle
    np.testing.assert_array_equal(found, h_found)
    np.testing.assert_array_equal(pos[found], h_pos[h_found])


@pytest.mark.parametrize("window", [16, 32])
def test_windowed_probe_chains_cross_small_windows(window):
    """The windowed pass structure with windows far shorter than the
    collision run: continuation passes must resolve exactly as the host
    walk does (the reference pins its kernel the same way)."""
    m, qs = _chain_case()
    h_pos, h_found = m._probe(qs)
    keys = port_ref.wrap_pad(torch.from_numpy(m.key_table.copy()),
                             cap=m.capacity, window=window)
    pos, found = port_ref.hashmap_probe_hbm(
        keys, torch.from_numpy(qs), shift=int(m.shift), window=window)
    np.testing.assert_array_equal(found.numpy(), h_found)
    np.testing.assert_array_equal(pos.numpy()[h_found], h_pos[h_found])


def test_home_slots_match_host_hash():
    """int64 multiply-and-mask equals the host's uint64 Fibonacci hash
    at every capacity, negative ids included."""
    rng = np.random.default_rng(3)
    ids = rng.integers(-2 ** 63, 2 ** 63 - 1, size=4096, dtype=np.int64)
    for cap_pow in (4, 12, 21, 24, 31):
        shift = 64 - cap_pow
        np.testing.assert_array_equal(
            port_ref.home_slots(torch.from_numpy(ids), shift).numpy(),
            ref_hashmap.home_slots(ids, np.uint64(shift)))
