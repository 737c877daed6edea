"""The fused train push after its probe (``ftrl_apply_slots``) and the
port's ``ops.fused_ftrl_apply`` on the CPU, against the JAX package.

On CPU tensors both run the plain versions (slot translate, gather, FTRL,
scatter-set). Their arenas and row outputs must be bit-equal to the JAX
package's NumPy FTRL route (``FTRL.update_rows(backend="numpy")``) applied
at the host map's slots, the arithmetic the CUDA kernel repeats. Against
the JAX package's ``ops.fused_ftrl_apply`` (Pallas in interpret mode, ids
in uint32 limbs) they agree in ``found`` and in every arena row the push
does not touch bit for bit, and in the updated rows within ``rtol=1e-5,
atol=1e-6``: XLA contracts ``n + g*g`` into one fused multiply-add on the
CPU, which rounds once where NumPy rounds twice (the tolerance of
``tests/test_torch_optim.py``). NaN stands for NaN in every comparison
(``codec_same``): the card and the host give NaNs of other payloads."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hashmap import IdHashMap
from repro.kernels import ops as ref_ops
from repro.optim import get_optimizer as ref_get_optimizer
from repro_torch.kernels import ftrl_row_update as port_ftrl
from repro_torch.kernels import hashmap_probe as port_hm
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import ref as port_ref

KW = dict(alpha=0.05, beta=1.0, l1=0.5, l2=1.0)
ARENA_ROWS = 1200


def same(a, b) -> bool:
    """Bit-equal arrays, NaNs in the same places standing for equal."""
    a, b = np.asarray(a), np.asarray(b)
    nan = np.isnan(a)
    return (a.shape == b.shape and np.array_equal(nan, np.isnan(b))
            and np.array_equal(np.where(nan, 0, a).view(np.uint8),
                               np.where(nan, 0, b).view(np.uint8)))


def push_case(b: int, d: int, seed: int, *, edge: bool = False):
    """A map of 1,000 ids over a 1,200-row arena (tombstones included),
    seeded (z, n, w) arenas, ``b`` unique present ids and their gradient
    rows. ``edge`` plants the update's edge elements in the pushed rows:
    |z| exactly l1, n = 0, g = 0, a denormal z, NaN and ±Inf in g."""
    rng = np.random.default_rng(seed)
    m = IdHashMap(16)
    ids = rng.choice(1 << 40, size=1100, replace=False).astype(np.int64)
    m.put(ids, rng.permutation(ARENA_ROWS)[:1100])
    m.delete(ids[1000:])
    ids = ids[:1000]
    z = (rng.normal(size=(ARENA_ROWS, d)) * 1.5).astype(np.float32)
    n = rng.uniform(0, 4, size=(ARENA_ROWS, d)).astype(np.float32)
    w = rng.normal(size=(ARENA_ROWS, d)).astype(np.float32)
    q = rng.permutation(ids)[:b]
    grads = rng.normal(size=(b, d)).astype(np.float32)
    if edge:
        sl = m.lookup(q)
        zf, nf = z[sl].reshape(-1), n[sl].reshape(-1)
        gf = grads.reshape(-1)
        zf[0], zf[1], nf[2], gf[3] = KW["l1"], -KW["l1"], 0.0, 0.0
        zf[4], zf[5], nf[5] = 1e-40, -3e-39, 0.0           # denormal z
        gf[6], gf[7], gf[8] = np.nan, np.inf, -np.inf
        zf[7] = 0.0                                         # w = 0 there
        zf[9], gf[9] = 4.0, np.inf                          # |z| > l1
        z[sl], n[sl] = zf.reshape(b, d), nf.reshape(b, d)
    return m, z, n, w, q, grads


def numpy_push(m, z, n, w, q, grads):
    """The JAX package's NumPy FTRL route at the host map's slots: the
    arenas after the push and the row outputs ``(z', n', w')``."""
    sl = m.lookup(q)
    w2, slots = ref_get_optimizer("ftrl", **KW).update_rows(
        w[sl], {"z": z[sl], "n": n[sl]}, grads, 0, backend="numpy")
    arenas = [a.copy() for a in (z, n, w)]
    for a, v in zip(arenas, (slots["z"], slots["n"], w2)):
        a[sl] = v
    return arenas, (slots["z"], slots["n"], w2)


def port_keys(m, placement):
    keys = torch.from_numpy(m.key_table.copy())
    if port_ops.resolve_placement(m.shift, placement) == "hbm":
        keys = port_hm.wrap_pad(keys, cap=m.capacity)
    return keys


def port_push(m, z, n, w, q, grads, placement, *, entry="ops",
              w_dtype=torch.float32):
    """The port's push on CPU tensors, through ``ops.fused_ftrl_apply``
    or through the probe and ``ref.ftrl_apply_slots``. Returns the
    arenas after it, the row outputs and ``found``."""
    arenas = [torch.from_numpy(a.copy()) for a in (z, n)]
    arenas.append(torch.from_numpy(w.copy()).to(w_dtype))
    slot_of = torch.from_numpy(m.val_table.astype(np.int32))
    keys, ids = port_keys(m, placement), torch.from_numpy(q)
    g = torch.from_numpy(grads)
    if entry == "ops":
        *rows, found = port_ops.fused_ftrl_apply(
            keys, slot_of, *arenas, ids, g, shift=int(m.shift),
            placement=placement, **KW)
    else:
        pos, found = port_ops.hashmap_probe(keys, ids, shift=int(m.shift),
                                            placement=placement)
        rows = port_ref.ftrl_apply_slots(pos, found, slot_of, *arenas, g,
                                         **KW)
    return arenas, rows, found


def jax_push(m, z, n, w, q, grads, placement):
    klo, khi = ref_ops.int64_limbs(m.key_table)
    qlo, qhi = ref_ops.int64_limbs(q)
    z_a, n_a, w_a, z2, n2, w2, found = ref_ops.fused_ftrl_apply(
        klo, khi, m.val_table.astype(np.int32), jnp.asarray(z),
        jnp.asarray(n), jnp.asarray(w), qlo, qhi, grads,
        shift=int(m.shift), placement=placement, **KW)
    return ([np.asarray(a) for a in (z_a, n_a, w_a)],
            [np.asarray(a) for a in (z2, n2, w2)], np.asarray(found))


def check_push(case, placement):
    m, z, n, w, q, grads = case
    want_arenas, want_rows = numpy_push(*case)
    j_arenas, j_rows, j_found = jax_push(*case, placement)
    untouched = np.ones(ARENA_ROWS, bool)
    untouched[m.lookup(q)] = False
    for entry in ("ops", "ref"):
        arenas, rows, found = port_push(*case, placement, entry=entry)
        assert found.all() and np.array_equal(found.numpy(), j_found)
        for got, want, pallas in zip(arenas, want_arenas, j_arenas):
            assert same(got, want), entry
            assert same(got[untouched], pallas[untouched]), entry
            np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5,
                                       atol=1e-6)
        for got, want, pallas in zip(rows, want_rows, j_rows):
            assert got.dtype == torch.float32
            assert same(got, want), entry
            np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("placement", ["vmem", "hbm"])
@pytest.mark.parametrize("b", [1, 700])
@pytest.mark.parametrize("d", [1, 4, 8, 9])
def test_push_matches_reference(d, b, placement):
    check_push(push_case(b, d, seed=b * 10 + d), placement)


@pytest.mark.parametrize("placement", ["vmem", "hbm"])
@pytest.mark.parametrize("d", [1, 8])
def test_push_edge_elements_match_reference(d, placement):
    case = push_case(64, d, seed=d, edge=True)
    check_push(case, placement)
    m, z, n, _w, q, grads = case
    sl = m.lookup(q)
    zf, nf, gf = z[sl].reshape(-1), n[sl].reshape(-1), grads.reshape(-1)
    _arenas, rows, _found = port_push(*case, placement)
    z2, n2, w2 = (r.numpy().reshape(-1) for r in rows)
    # |z| == l1 weighs 0, so z' = z + g; g = 0 leaves (z, n) as they were
    assert z2[0] == zf[0] + gf[0] and z2[1] == zf[1] + gf[1]
    assert z2[3] == zf[3] and n2[3] == nf[3]
    assert np.isnan(n2[6]) and np.isnan(z2[6]) and w2[6] == 0
    assert n2[7] == np.inf and np.isnan(z2[7])         # inf - inf * 0


@pytest.mark.parametrize("w_dtype", [torch.float16, torch.bfloat16])
def test_push_rounds_w_into_a_16_bit_arena(w_dtype):
    """A w arena of float16 or bfloat16 takes w' rounded to nearest even
    (the chain's cast); the row outputs stay float32."""
    case = push_case(300, 8, seed=5)
    m, _z, _n, w, q, _g = case
    want_arenas, want_rows = numpy_push(*case)
    arenas, rows, _found = port_push(*case, "vmem", w_dtype=w_dtype)
    sl = m.lookup(q)
    assert arenas[2].dtype == w_dtype
    assert torch.equal(arenas[2][sl], torch.from_numpy(want_rows[2])
                       .to(w_dtype))
    keep = np.setdiff1d(np.arange(ARENA_ROWS), sl)
    assert torch.equal(arenas[2][keep], torch.from_numpy(w[keep])
                       .to(w_dtype))
    for got, want in zip(rows, want_rows):
        assert same(got, want)


def _slots_args(b=5, d=4, rows=16):
    """Valid CPU arguments of ``ftrl_apply_slots``, as a dict."""
    return dict(pos=torch.arange(b, dtype=torch.int32),
                found=torch.ones(b, dtype=torch.bool),
                slot_of=torch.arange(rows, dtype=torch.int32),
                z_arena=torch.zeros(rows, d), n_arena=torch.zeros(rows, d),
                w_arena=torch.zeros(rows, d), grads=torch.ones(b, d))


@pytest.mark.parametrize("what", [
    "grads (B, D + 1)", "grads (B * D,)", "z arena float64",
    "n arena float16", "w arena float64", "w arena int32",
    "z arena not contiguous", "w arena not contiguous", "pos int64",
    "found of another length", "grads on another device",
    "a push past 2^31 - 1 floats"])
def test_apply_slots_rejects_bad_inputs(what):
    """``ValueError`` — never ``AssertionError``, and before the device
    dispatch, so the CPU and the card raise alike."""
    a = _slots_args()
    if what == "grads (B, D + 1)":
        a["grads"] = torch.ones(5, 5)
    elif what == "grads (B * D,)":
        a["grads"] = torch.ones(20)
    elif what.startswith(("z arena float", "n arena float", "w arena f",
                          "w arena int")):
        key = what[0] + "_arena"
        a[key] = a[key].to(getattr(torch, what.split()[-1]))
    elif what.endswith("not contiguous"):
        key = what[0] + "_arena"
        a[key] = torch.zeros(4, 16).t()
    elif what == "pos int64":
        a["pos"] = a["pos"].long()
    elif what == "found of another length":
        a["found"] = torch.ones(6, dtype=torch.bool)
    elif what == "grads on another device":
        a["grads"] = a["grads"].to("meta")
    else:                   # shapes only: meta tensors hold no memory
        b = 2 ** 31
        a = dict(pos=torch.empty(b, dtype=torch.int32, device="meta"),
                 found=torch.empty(b, dtype=torch.bool, device="meta"),
                 slot_of=a["slot_of"], z_arena=a["z_arena"],
                 n_arena=a["n_arena"], w_arena=a["w_arena"],
                 grads=torch.empty(b, 4, device="meta"))
    with pytest.raises(ValueError):
        port_ftrl.ftrl_apply_slots(**a, **KW)


def test_apply_slots_counts_no_launch_on_the_cpu():
    """CPU tensors take the plain version: no kernel launch is counted,
    the arenas are updated in place and an empty push changes nothing."""
    a = _slots_args()
    before = port_ops.launch_counts()
    rows = port_ftrl.ftrl_apply_slots(**a, **KW)
    assert port_ops.launch_counts() == before
    assert torch.equal(a["z_arena"][:5], rows[0])
    assert torch.equal(a["n_arena"][:5], torch.ones(5, 4))
    empty = _slots_args(b=0)
    out = port_ftrl.ftrl_apply_slots(**empty, **KW)
    assert all(t.shape == (0, 4) for t in out)
    assert not empty["z_arena"].any()


@pytest.mark.parametrize("what", ["z of another shape", "rows not 2-D",
                                  "g on another device"])
def test_row_update_rejects_bad_inputs(what):
    """The standalone entry checks before its device dispatch too."""
    z, n, g = torch.zeros(3, 4), torch.zeros(3, 4), torch.ones(3, 4)
    if what == "z of another shape":
        z = torch.zeros(3, 5)
    elif what == "rows not 2-D":
        z, n, g = z.reshape(-1), n.reshape(-1), g.reshape(-1)
    else:
        g = g.to("meta")
    with pytest.raises(ValueError):
        port_ftrl.ftrl_row_update(z, n, g, **KW)


def test_apply_slots_on_a_misaligned_arena_view():
    """Arenas one float into their storage (no 16-byte boundary under
    their rows) are updated in place like contiguous ones: the CUDA pass
    makes no alignment assumption, and the CPU route is the chain."""
    case = push_case(300, 8, seed=9)
    m, z, n, w, q, grads = case
    want_arenas, want_rows = numpy_push(*case)
    views = []
    for a in (z, n, w):
        flat = torch.zeros(a.size + 1)
        view = flat[1:].view(a.shape)
        view.copy_(torch.from_numpy(a))
        views.append(view)
    pos, found = port_ops.hashmap_probe(port_keys(m, "vmem"),
                                        torch.from_numpy(q),
                                        shift=int(m.shift), placement="vmem")
    rows = port_ftrl.ftrl_apply_slots(
        pos, found, torch.from_numpy(m.val_table.astype(np.int32)), *views,
        torch.from_numpy(grads), **KW)
    for got, want in zip([*views, *rows], [*want_arenas, *want_rows]):
        assert same(got, want)
