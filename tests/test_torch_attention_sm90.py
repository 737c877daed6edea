"""The arithmetic of the card's redesigned attention kernels, on the CPU.

* ``flash_attention`` in bfloat16 runs on the tensor cores
  (``csrc/flash_attention_sm90.cu``): scores are bf16 x bf16 products
  summed in float32 and then scaled by ``D^-0.5``, and the probabilities
  are rounded to bfloat16 before P.V. An emulation of those roundings in
  plain torch is held within 2e-2 (the reference's bf16 tolerance) of the
  reference's Pallas ``flash_attention`` in interpret mode.
* ``decode_attention`` splits each sequence's cache into runs of rows
  (``split_plan``) and combines the runs' partial softmaxes in split
  order. The plan is checked, and an emulation of split-then-combine is
  held against the plain version (2e-5 in float32: sums in another order)
  and against the Pallas ``decode_attention`` in interpret mode.
* With a bfloat16 query against a bfloat16 cache it runs on the tensor
  cores (``mma_split_plan``): scores summed in float32 and then scaled,
  P entering P.V as a bfloat16 hi + lo pair. That plan is checked, and
  an emulation of its arithmetic is held against the plain version and
  the Pallas kernel alike.

Inputs come from numpy with a seed and are handed to both packages.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import decode_attention as port_da
from repro_torch.kernels import ref as port_ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402

NEG_INF = -1e30


def _bf16_pair(a: np.ndarray):
    """One numpy array rounded to bfloat16, as JAX's and torch's input."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def flash_sm90_emulation(q, k, v, *, causal: bool) -> torch.Tensor:
    """The tensor-core kernel's arithmetic: q (B, H, S, D), k and v
    (B, G, T, D) in bfloat16. ``s = (q . k) * D^-0.5`` in float32; keys
    masked with -1e30; ``p = exp(s - max)`` rounded to bfloat16 for P.V
    while ``l`` sums the unrounded p; the output rounded to bfloat16."""
    b, h, s, d = q.shape
    g, t = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, g, h // g, s, d)
    scores = torch.einsum("bgmsd,bgtd->bgmst", qf, k.float()) * np.float32(
        d ** -0.5)
    if causal:
        keep = torch.ones((s, t), dtype=torch.bool).tril()
        scores = scores.masked_fill(~keep, NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = torch.einsum("bgmst,bgtd->bgmsd", p.to(torch.bfloat16).float(),
                      v.float())
    return (pv / den).reshape(b, h, s, d).to(torch.bfloat16)


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_emulation_matches_reference_kernel(s, d, causal):
    b, h, g = 2, 4, 2
    rng = np.random.default_rng(s + d + causal)
    (jq, tq), (jk, tk), (jv, tv) = (
        _bf16_pair(rng.standard_normal(shape, dtype=np.float32))
        for shape in ((b, h, s, d), (b, g, s, d), (b, g, s, d)))
    want = jax_ops.flash_attention(jq, jk, jv, causal=causal, block_q=128,
                                   block_k=128)
    got = flash_sm90_emulation(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    # and the plain version the card's kernel is checked against
    plain = port_ref.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("s,b,g", [
    (4096, 4, 2),        # qwen2-1.5b's long decode
    (4096, 2, 4),        # qwen2-7b's groups
    (4096, 1, 2),
    (300, 3, 2),
    (64, 4, 2),
    (1, 1, 1),
    (4033, 64, 4),       # more (sequence, group) pairs than 264
    (16384, 128, 2),     # the decode cell: B * G = 256
])
def test_split_plan_covers_the_cache(s, b, g):
    splits, rows = port_da.split_plan(s, b, g)
    assert rows >= port_da.CHUNK and rows % port_da.CHUNK == 0
    # the runs [i * rows, (i + 1) * rows) cover [0, S), none starts past it
    assert splits * rows >= s and (splits - 1) * rows < s
    starts = np.arange(splits) * rows
    assert np.all(np.diff(starts) == rows) and starts[0] == 0
    # the card is covered twice wherever the cache has the rows for it
    target = port_da.TARGET_BLOCKS
    if s >= port_da.CHUNK * -(-target // (b * g)):
        assert b * g * splits >= target


def test_split_plan_at_the_long_decode_shape():
    splits, rows = port_da.split_plan(4096, 4, 2)
    assert 4 * 2 * splits >= 264 and rows <= 128 and splits >= 32


@pytest.mark.parametrize("s,b,g", [
    (4096, 4, 2),        # qwen2-1.5b's long decode
    (4096, 2, 4),        # qwen2-7b's groups
    (4096, 1, 2),
    (300, 3, 2),
    (64, 4, 2),
    (1, 1, 1),
    (4033, 64, 4),       # more (sequence, group) pairs than 264
    (16384, 128, 2),     # the decode cell: B * G = 256
    (4096, 4, 8),        # jamba's long decode: between the two holds
])
def test_mma_split_plan_covers_the_cache(s, b, g):
    splits, rows = port_da.mma_split_plan(s, b, g)
    tile, least, most = port_da.TILE, port_da.MIN_ROWS, port_da.MAX_ROWS
    assert least <= rows <= most and rows % tile == 0
    assert splits * rows >= s and (splits - 1) * rows < s
    # rows is S * B * G / TARGET_BLOCKS (about one wave of the card's
    # resident blocks) rounded up to a tile, held within [least, most]
    work, target = s * b * g, port_da.TARGET_BLOCKS
    if rows > least:
        assert work > (rows - tile) * target
    if rows < most:
        assert work <= rows * target


def test_mma_split_plan_at_the_decode_cell_shape():
    """B 128 x G 2 = 256 (sequence, group) pairs over 16,384 rows: splits
    of 1,024 rows, the most a split holds (no block walks more than a
    sixteenth of the cache), many waves of the card's 264 resident
    blocks."""
    splits, rows = port_da.mma_split_plan(16384, 128, 2)
    assert rows == port_da.MAX_ROWS == 16384 // 16
    assert 128 * 2 * splits >= 8 * 264
    # the partials, written and read once, add at most 3% of the live
    # rows' bytes for 6 query heads of 128 a group
    assert 2 * 6 * (128 + 2) * 4 <= 0.03 * rows * 2 * 128 * 2


def _split_combine(q, k, v, lengths, rows: int, partial) -> torch.Tensor:
    """Split-then-combine in float32: ``partial(q_group, k_rows, v_rows)``
    gives each split's (m_i, l_i, acc_i) over its rows below the length;
    then, in split order, ``m* = max m_i``, ``l = sum l_i e^(m_i - m*)``
    and acc alike; splits past the length add nothing. q (B, H, D); k, v
    (B, S, G, D). Returns float32 (B, H, D)."""
    b, h, d = q.shape
    g = k.shape[2]
    qg = q.float().reshape(b, g, h // g, d)
    out = torch.empty((b, g, h // g, d))
    for bi in range(b):
        n = int(lengths[bi])
        used = -(-n // rows)
        for gi in range(g):
            parts = []
            for i in range(used):
                lo, hi = i * rows, min((i + 1) * rows, n)
                parts.append(partial(qg[bi, gi], k[bi, lo:hi, gi].float(),
                                     v[bi, lo:hi, gi].float()))
            m_star = torch.stack([p[0] for p in parts]).amax(0)
            l_sum = torch.zeros_like(m_star)
            acc = torch.zeros((h // g, d))
            for mi, li, ai in parts:                         # split order
                w = torch.exp(mi - m_star)
                l_sum = l_sum + li * w
                acc = acc + ai * w
            out[bi, gi] = acc / l_sum.clamp_min(1e-30)
    return out.reshape(b, h, d)


def split_decode_emulation(q, k, v, lengths) -> torch.Tensor:
    """The CUDA-core kernel's arithmetic in float32 under ``split_plan``:
    q scaled on float32 values, each split's softmax and P.V in float32.
    q (B, H, D); k, v (B, S, G, D)."""
    b, h, d = q.shape
    _, rows = port_da.split_plan(k.shape[1], b, k.shape[2])
    scale = np.float32(d ** -0.5)

    def partial(qg, kr, vr):
        sc = (qg * scale) @ kr.T                           # (m, rows)
        mi = sc.amax(dim=-1, keepdim=True)
        p = torch.exp(sc - mi)
        return mi, p.sum(-1, keepdim=True), p @ vr
    return _split_combine(q, k, v, lengths, rows, partial).to(q.dtype)


def mma_decode_emulation(q, k, v, lengths, *, p_lo: bool = True
                         ) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in float32 under
    ``mma_split_plan`` (q, k, v hold bfloat16 values): scores ``q . k^T``
    summed in float32 and then times ``D^-0.5``; ``p = exp(s - m_i)``,
    ``l_i`` summing the float32 p, and P.V taking p as its bfloat16 hi
    plus the bfloat16 of what hi leaves (``p_lo=False``: hi alone, the
    rounding the kernel does not make). The warps' merge inside a split
    and the online rescaling reorder float32 sums only. Returns float32
    (B, H, D), the kernel's sums before its output's bfloat16 cast."""
    b, h, d = q.shape
    _, rows = port_da.mma_split_plan(k.shape[1], b, k.shape[2])
    scale = np.float32(d ** -0.5)

    def bf16(x):
        return x.to(torch.bfloat16).float()

    def partial(qg, kr, vr):
        sc = (qg @ kr.T) * scale
        mi = sc.amax(dim=-1, keepdim=True)
        p = torch.exp(sc - mi)
        hi = bf16(p)
        pp = hi + bf16(p - hi) if p_lo else hi
        return mi, p.sum(-1, keepdim=True), pp @ vr
    return _split_combine(q, k, v, lengths, rows, partial)


@pytest.mark.parametrize("b,h,g,s,d,lengths", [
    (4, 12, 2, 1024, 128, None),      # qwen2-1.5b heads: boundaries, 1, S
    (2, 28, 4, 512, 128, None),       # qwen2-7b: 7 heads per group
    (3, 4, 2, 300, 64, [1, 300, 64]),
])
def test_split_decode_emulation_matches_plain_and_reference(b, h, g, s, d,
                                                            lengths):
    rng = np.random.default_rng(b * s + d)
    q = rng.standard_normal((b, h, d), dtype=np.float32)
    k = rng.standard_normal((b, s, g, d), dtype=np.float32)
    v = rng.standard_normal((b, s, g, d), dtype=np.float32)
    if lengths is None:
        _, rows = port_da.split_plan(s, b, g)
        lengths = [1, s, rows, 2 * rows][:b]     # on split boundaries
    lengths = np.asarray(lengths, np.int32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = split_decode_emulation(tq, tk, tv, lengths)
    plain = port_ref.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    torch.testing.assert_close(got, plain, rtol=2e-5, atol=2e-5)
    want = jax_ops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(lengths),
                                    block_k=128 if s % 128 == 0 else s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("b,h,g,s,d,lengths", [
    (4, 12, 2, 2048, 128, None),      # qwen2-1.5b heads: boundaries, 1, S
    (2, 28, 4, 512, 128, None),       # qwen2-7b: 7 heads per group
    (3, 16, 1, 300, 64, [1, 300, 64]),  # 16 heads a group
    (2, 8, 4, 256, 256, [256, 130]),  # the wide head, 2 a group
])
def test_mma_decode_emulation_matches_plain_and_reference(b, h, g, s, d,
                                                          lengths):
    """2e-5, as the float32 split emulation: P's hi + lo keeps 2^-17 of
    each p, so P.V moves by under 1e-5 of the largest |v| (~4 here) and
    the rest is float32 sums in another order. With P rounded to
    bfloat16 alone (2^-9 of each p) the same emulation misses by more,
    so the tolerance tells the kernel's rounding from the one it must
    not make. The inputs hold bfloat16 values, as the path's do."""
    rng = np.random.default_rng(7 * b * s + d)
    q, k, v = (np.asarray(_bf16_pair(rng.standard_normal(
        shape, dtype=np.float32))[1].float())
        for shape in ((b, h, d), (b, s, g, d), (b, s, g, d)))
    if lengths is None:
        _, rows = port_da.mma_split_plan(s, b, g)
        lengths = [1, s, rows, rows + 1, rows - 1, 2 * rows][:b]
    lengths = np.asarray(lengths, np.int32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = mma_decode_emulation(tq, tk, tv, lengths)
    plain = port_ref.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    torch.testing.assert_close(got, plain, rtol=2e-5, atol=2e-5)
    want = jax_ops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(lengths),
                                    block_k=128 if s % 128 == 0 else s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    hi_only = mma_decode_emulation(tq, tk, tv, lengths, p_lo=False)
    assert float((hi_only - plain).abs().max()) > 2e-5


@pytest.mark.parametrize("drop", ["last of split 0", "first of split 1"])
def test_one_ulp_check_passes_the_emulation_and_fails_a_dropped_row(drop):
    """The card's check of the bf16 path (``chip_smoke.bf16_ulp_excess``:
    one bf16 ulp, plus 1e-5) passes this emulation of the kernel's
    arithmetic, rounded to bf16 as the kernel's output is, and fails the
    plain version with one cache row left out at a split boundary of the
    longest sequence."""
    b, h, g, s, d = 4, 12, 2, 4096, 128
    rng = np.random.default_rng(41)
    q, k, v = (_bf16_pair(rng.standard_normal(shape, dtype=np.float32))[1]
               for shape in ((b, h, d), (b, s, g, d), (b, s, g, d)))
    lengths = torch.tensor([s, 4001, 2048, 1025], dtype=torch.int32)
    want = port_ref.decode_attention(q, k, v, lengths)
    got = mma_decode_emulation(q.float(), k.float(), v.float(), lengths)
    assert smoke.bf16_ulp_excess(got.bfloat16(), want) <= 0
    _, rows = port_da.mma_split_plan(s, b, g)
    r = rows - 1 if drop == "last of split 0" else rows
    fault = smoke.plain_decode_without_row(q, k, v, lengths, 0, r)
    assert smoke.bf16_ulp_excess(fault, want[:1]) > 0
