"""The port's row scatter-add — the LM embedding gradient's kernel —
against the JAX package, on the CPU.

The plain version (``kernels/ref.py``), which the wrapper runs for CPU
tensors, adds each id's duplicates in input order and rounds to the
table's dtype after every add, as the Pallas kernel's sequential ``+=``
does: so it is bit-equal to ``repro.kernels.ops.embedding_scatter_add``
in interpret mode, in float32 and bfloat16. Against the reference's own
oracle (``table.at[ids].add``) it stays within the reference's rtol
1e-5. ``embed_tokens``'s gradient (gather forward, scatter-add backward)
equals JAX's gradient of ``embed[tokens]``. The CUDA kernel's lane word
(``scatter_add_word``) is checked here too; the kernel itself runs in
``test_torch_cuda.py``.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import zipf_ids  # noqa: E402
from repro.data import lm_batches as jax_lm_batches
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import embedding_lookup as port_el
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import ref as port_ref
from repro_torch.models.common import embed_tokens

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(v, d, n, kind="uniform", *, seed, ids=None):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d), dtype=np.float32)
    if ids is None and kind == "zipf":
        ids = zipf_ids(n, v, rng).astype(np.int32)
    elif ids is None:
        ids = rng.integers(0, v, size=n).astype(np.int32)
    upd = (3 * rng.standard_normal((len(ids), d))).astype(np.float32)
    return table, ids, upd


def _both(table, ids, upd, dtype):
    """(Pallas kernel in interpret mode, the port's wrapper on the CPU)
    results as float32 numpy; the port's launch counters must not move."""
    jdt, tdt = DTYPES[dtype]
    want = jax_ops.embedding_scatter_add(jnp.asarray(table).astype(jdt),
                                         jnp.asarray(ids), jnp.asarray(upd))
    before = port_ops.launch_counts()
    got = port_ops.embedding_scatter_add(torch.from_numpy(table).to(tdt),
                                         torch.from_numpy(ids),
                                         torch.from_numpy(upd))
    assert port_ops.launch_counts() == before
    assert got.dtype == tdt
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


CASES = {
    "sweep_64x128": (64, 128, 16),          # the reference's sweep
    "sweep_128x256": (128, 256, 64),
    "dups_16x96": (16, 96, 300),            # ~19 duplicates a row
    "wide_40x1536": (40, 1536, 200),        # qwen2's row width
    "zipf_500x64": (500, 64, 400, "zipf"),  # text-like skew: ~60 of one id
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_is_bit_equal_to_pallas_interpret(case, dtype):
    table, ids, upd = _inputs(*CASES[case], seed=len(case))
    want, got = _both(table, ids, upd, dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_heavy_duplicates_and_lm_batch_ids(dtype):
    """All ids on one row (the reference's heavy-duplicate case, with
    random updates so the order of the adds shows), then the ids of an
    ``lm_batches`` batch, whose bigram structure repeats tokens."""
    table, ids, upd = _inputs(8, 128, 64, seed=1,
                              ids=np.zeros(64, np.int32))
    want, got = _both(table, ids, upd, dtype)
    np.testing.assert_array_equal(got, want)
    tokens = next(jax_lm_batches(97, 4, 64, seed=3)).reshape(-1)
    assert len(np.unique(tokens)) < len(tokens) // 2
    table, ids, upd = _inputs(97, 64, 0, seed=2, ids=tokens)
    want, got = _both(table, ids, upd, dtype)
    np.testing.assert_array_equal(got, want)


def test_ones_accumulate_exactly():
    """The reference's heavy-duplicate test: 64 ones onto a zero row."""
    got = port_ops.embedding_scatter_add(
        torch.zeros((8, 128)), torch.zeros(64, dtype=torch.int32),
        torch.ones((64, 128)))
    np.testing.assert_allclose(got[0].numpy(), np.full(128, 64.0), rtol=1e-6)
    np.testing.assert_allclose(got[1:].numpy(), np.zeros((7, 128)))


@pytest.mark.parametrize("case", list(CASES))
def test_within_reference_oracle_tolerance(case):
    table, ids, upd = _inputs(*CASES[case], seed=7)
    want = np.asarray(jax_ref.embedding_scatter_add(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(upd)))
    got = port_ops.embedding_scatter_add(torch.from_numpy(table.copy()),
                                         torch.from_numpy(ids),
                                         torch.from_numpy(upd)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_empty_ids_is_a_no_op_and_returns_the_table():
    table = torch.randn(10, 4)
    before = table.clone()
    for ids in (torch.zeros(0, dtype=torch.int32),
                torch.zeros(0, dtype=torch.int64)):
        out = port_ops.embedding_scatter_add(table, ids, torch.zeros(0, 4))
        assert out is table and torch.equal(table, before)
    want = jax_ref.embedding_scatter_add(
        jnp.asarray(before.numpy()), jnp.zeros(0, jnp.int32),
        jnp.zeros((0, 4)))
    np.testing.assert_array_equal(table.numpy(), np.asarray(want))


def test_updates_cast_to_the_table_dtype_first():
    """float32 updates onto a bfloat16 table are rounded to bfloat16
    before they are added, as the reference's ``astype`` does."""
    table, ids, upd = _inputs(32, 64, 100, seed=9)
    upd = upd * np.float32(1.0 + 2 ** -12)        # bits below bf16
    want, got = _both(table, ids, upd, "bfloat16")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_embed_tokens_gradient_matches_jax(dtype):
    """``embed_tokens``: forward ``table[tokens]`` exactly; the gradient
    of ``sum(embed[tokens] * w)`` equals JAX's (XLA differentiates the
    gather into a scatter-add; both add duplicates in input order)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    table = rng.standard_normal((50, 32), dtype=np.float32)
    tokens = rng.integers(0, 50, size=(3, 40)).astype(np.int32)
    w = rng.standard_normal((3, 40, 32), dtype=np.float32)

    def jloss(e):
        return (e[jnp.asarray(tokens)].astype(jnp.float32) * w).sum()

    jt = jnp.asarray(table).astype(jdt)
    want = jax.grad(jloss)(jt)
    t = torch.from_numpy(table).to(tdt).requires_grad_(True)
    out = embed_tokens(t, torch.from_numpy(tokens))
    np.testing.assert_array_equal(
        out.detach().float().numpy(),
        np.asarray(jt[jnp.asarray(tokens)].astype(jnp.float32)))
    (got,) = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(),
                                 [t])
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_plain_version_matches_index_add_on_unique_ids():
    """With unique ids the order question vanishes: the plain version
    equals ``index_add_`` exactly."""
    table = torch.randn(100, 8)
    ids = torch.randperm(100)[:60]
    upd = torch.randn(60, 8)
    got = port_ref.embedding_scatter_add(table.clone(), ids, upd)
    assert torch.equal(got, table.clone().index_add_(0, ids, upd))


def test_zipf_case_is_skewed():
    """The Zipf case puts one id on dozens of positions (longer than the
    kernel's 32-row chunks of ``order``), the rest mostly once."""
    _, ids, _ = _inputs(*CASES["zipf_500x64"], seed=len("zipf_500x64"))
    counts = np.bincount(ids)
    assert counts.max() > 40 and (counts == 1).sum() > 50


def test_sort_ids_is_stable():
    """The kernel's inputs: the ids sorted as int32, and the stable
    sort's order as int64 (read by the kernel as is), each id's
    positions in input order."""
    ids = torch.tensor([5, 2, 5, 0, 2, 5, 9, 0], dtype=torch.int64)
    sorted_ids, order = port_el.sort_ids(ids)
    assert sorted_ids.dtype == torch.int32 and order.dtype == torch.int64
    assert sorted_ids.tolist() == [0, 0, 2, 2, 5, 5, 5, 9]
    assert order.tolist() == [3, 7, 1, 4, 0, 2, 5, 6]


def _view(dtype, n, d, view):
    big = torch.zeros((n, d + 8), dtype=dtype)
    return {"contiguous": big[:, :d].contiguous(), "strided": big[:, :d],
            "misaligned": big[:, 1:d + 1]}[view]


@pytest.mark.parametrize("dtype,d,view,word", [
    (torch.bfloat16, 1536, "contiguous", 16),   # qwen2's gradient
    (torch.float32, 1536, "contiguous", 16),
    (torch.bfloat16, 1536, "strided", 16),      # read in place
    (torch.bfloat16, 1536, "misaligned", 2),
    (torch.float32, 1536, "misaligned", 4),
    (torch.bfloat16, 1, "contiguous", 2),
    (torch.bfloat16, 9, "contiguous", 2),
    (torch.float32, 2, "contiguous", 8),
    (torch.float32, 257, "contiguous", 4),
    (torch.float32, 260, "strided", 16),
])
def test_scatter_add_word(dtype, d, view, word):
    """The widest word that divides both pointers, the table's row bytes
    and the updates' row stride."""
    table = torch.zeros((10, d), dtype=dtype)
    assert port_el.scatter_add_word(table, _view(dtype, 5, d, view)) == word
