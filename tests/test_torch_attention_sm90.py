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

Inputs come from numpy with a seed and are handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import decode_attention as port_da
from repro_torch.kernels import ref as port_ref

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


def split_decode_emulation(q, k, v, lengths) -> torch.Tensor:
    """The split kernel's arithmetic in float32: each split's partial
    (m_i, l_i, acc_i) over its rows below the length, then, in split
    order, ``m* = max m_i``, ``l = sum l_i e^(m_i - m*)`` and acc alike;
    splits past the length add nothing. q (B, H, D); k, v (B, S, G, D)."""
    b, h, d = q.shape
    s, g = k.shape[1], k.shape[2]
    splits, rows = port_da.split_plan(s, b, g)
    qf = q.float().reshape(b, g, h // g, d) * np.float32(d ** -0.5)
    out = torch.empty((b, g, h // g, d))
    for bi in range(b):
        n = int(lengths[bi])
        used = -(-n // rows)
        for gi in range(g):
            parts = []
            for i in range(used):
                lo, hi = i * rows, min((i + 1) * rows, n)
                sc = qf[bi, gi] @ k[bi, lo:hi, gi].float().T   # (m, rows)
                mi = sc.amax(dim=-1, keepdim=True)
                p = torch.exp(sc - mi)
                parts.append((mi, p.sum(-1, keepdim=True),
                              p @ v[bi, lo:hi, gi].float()))
            m_star = torch.stack([p[0] for p in parts]).amax(0)
            l_sum = torch.zeros_like(m_star)
            acc = torch.zeros((h // g, d))
            for mi, li, ai in parts:                         # split order
                w = torch.exp(mi - m_star)
                l_sum = l_sum + li * w
                acc = acc + ai * w
            out[bi, gi] = acc / l_sum.clamp_min(1e-30)
    return out.reshape(b, h, d).to(q.dtype)


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
