"""The port's sliding-window attention against the JAX package's, on the
CPU, on one layer of ``reduced(get_config("gemma3-4b"))`` with
``window_size`` 8 (d_model 256, 4 heads of 64 over 2 KV groups).

``self_attention`` takes the reference's three branches by S: S = 4 (the
window masks nothing: plain causal attention, the flash kernel's plain
version on the CPU), S = 12 (12 % 8 != 0: the masked whole-row softmax)
and S = 24 (the block-local branch, three blocks). Each is held against
the reference's ``self_attention`` (float32 within 1e-5, bfloat16 within
2e-2) and against a float64 NumPy oracle written here from the
definition (a causal softmax over the keys ``q - window < k <= q``): the
reference's own block-local test compares that branch with itself, so
the oracle is what holds both branches to the definition. Gradients
against ``jax.grad`` within 1e-4 of the largest. A windowed layer past
one chunk with S % window != 0 raises in both packages.

``decode_self_attention(window=8)`` writes a ring of 8 rows at ``pos %
8``; 20 positions wrap it twice. Outputs and ring contents are held
against the reference's. The port attends over the ring's first
``min(pos + 1, W)`` rows: a NumPy check that the reference's ring mask
(``src/repro/models/attention.py:263-268``) is that prefix.

Inputs come from numpy with a seed and are handed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import attention as jax_attn
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops as port_ops
from repro_torch.models import attention as port_attn

WINDOW = 8
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# S and the branch it takes at window 8 and the default chunk of 1024
BRANCHES = [(4, "void window"), (12, "masked"), (24, "block-local")]


def _cfgs():
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("gemma3-4b")),
                               window_size=WINDOW)
    cfg = dataclasses.replace(reduced(get_config("gemma3-4b")),
                              window_size=WINDOW)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)   # a copy
    return jcfg, cfg


def _layer(cfg, rng) -> dict:
    """One attention layer's parameters at the model's init scale, the
    variance 1 / fan-in (gemma3 has no QKV bias), so the output is of
    order 1 as the inputs are."""
    d, h, g, e = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": ((d, h, e), d), "wk": ((d, g, e), d),
              "wv": ((d, g, e), d), "wo": ((h, e, d), h * e)}
    return {k: rng.standard_normal(s, dtype=np.float32) * fan ** -0.5
            for k, (s, fan) in shapes.items()}


def _inputs(s: int, seed: int):
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(seed)
    p = _layer(cfg, rng)
    x = rng.standard_normal((2, s, cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    return jcfg, cfg, p, x, pos


def _both(a: np.ndarray, dtype: str):
    """``a`` rounded to ``dtype``: as the reference's input, the port's,
    and as float64 numpy of the rounded values."""
    j = jnp.asarray(a).astype(dtype)
    f = np.array(j.astype(jnp.float32))
    return j, torch.from_numpy(f).to(TORCH_DTYPE[dtype]), f.astype(np.float64)


def _rope64(x: np.ndarray, pos: np.ndarray, theta: float) -> np.ndarray:
    """Rotary embedding on dimension halves, float64."""
    half = x.shape[-1] // 2
    inv = theta ** -(np.arange(half) / half)
    ang = pos[..., None, None].astype(np.float64) * inv      # (b,s,1,half)
    x1, x2 = x[..., :half], x[..., half:]
    return np.concatenate([x1 * np.cos(ang) - x2 * np.sin(ang),
                           x2 * np.cos(ang) + x1 * np.sin(ang)], axis=-1)


def oracle(cfg, p: dict, x: np.ndarray, pos: np.ndarray,
           window: int) -> np.ndarray:
    """Sliding-window causal GQA self-attention from its definition, in
    float64: query i attends keys j with ``i - window < j <= i``."""
    b, s, _ = x.shape
    h, g, e = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _rope64(np.einsum("bsd,dhe->bshe", x, p["wq"]), pos, cfg.rope_theta)
    k = _rope64(np.einsum("bsd,dge->bsge", x, p["wk"]), pos, cfg.rope_theta)
    v = np.einsum("bsd,dge->bsge", x, p["wv"])
    kv = np.arange(h) // (h // g)                  # the KV group of a head
    scores = np.einsum("bshe,bthe->bhst", q, k[:, :, kv]) * e ** -0.5
    qp, kp = pos[:, None, :, None], pos[:, None, None, :]
    keep = (kp <= qp) & (kp > qp - window)
    scores = np.where(keep, scores, -np.inf)
    probs = np.exp(scores - scores.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.einsum("bhst,bthe->bshe", probs, v[:, :, kv])
    return np.einsum("bshe,hed->bsd", out, p["wo"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,branch", BRANCHES)
def test_self_attention_matches_reference_and_oracle(s, branch, dtype):
    jcfg, cfg, p, x, pos = _inputs(s, seed=s)
    pair = {k: _both(v, dtype) for k, v in p.items()}
    jx, tx, x64 = _both(x, dtype)
    want = jax_attn.self_attention({k: v[0] for k, v in pair.items()}, jx,
                                   jnp.asarray(pos), cfg=jcfg,
                                   window=WINDOW)
    before = port_ops.launch_counts()
    got = port_attn.self_attention({k: v[1] for k, v in pair.items()}, tx,
                                   torch.from_numpy(pos), cfg=cfg,
                                   window=WINDOW)
    assert port_ops.launch_counts() == before       # CPU: plain versions
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == x.shape
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    exact = oracle(cfg, {k: v[2] for k, v in pair.items()}, x64, pos,
                   WINDOW)
    print(f"{branch} S={s} {dtype}: vs the reference "
          f"{np.abs(got - want).max():.3g}, vs float64 "
          f"{np.abs(got - exact).max():.3g} (largest |out| "
          f"{np.abs(exact).max():.3g})")
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, exact, rtol=tol, atol=tol)


@pytest.mark.parametrize("s,branch", BRANCHES)
def test_self_attention_grads_match_jax_grad(s, branch):
    """Gradients of ``sum(w * out)`` with respect to x and every weight,
    within 1e-4 of each one's largest magnitude; the window's branches
    differentiate through autograd, the void window through
    ``_FlashAttention``'s backward."""
    jcfg, cfg, p, x, pos = _inputs(s, seed=100 + s)
    w = np.random.default_rng(s).standard_normal(x.shape, dtype=np.float32)

    def jloss(p, x):
        out = jax_attn.self_attention(p, x, jnp.asarray(pos), cfg=jcfg,
                                      window=WINDOW)
        return (out * jnp.asarray(w)).sum()

    jg = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = port_attn.self_attention(tp, tx, torch.from_numpy(pos), cfg=cfg,
                                   window=WINDOW)
    (out * torch.from_numpy(w)).sum().backward()
    pairs = [(tx.grad, jg[1])] + [(tp[k].grad, jg[0][k]) for k in p]
    for got, want in pairs:
        want = np.asarray(want)
        dev = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert dev <= 1e-4, dev


def test_windowed_layer_past_a_chunk_raises_in_both_packages():
    """S = 20 > chunk 16 with 20 % 8 != 0: the reference raises, and so
    does the port; at S = 24 the block-local branch runs past the chunk
    in both."""
    jcfg, cfg, p, x, pos = _inputs(20, seed=7)
    with pytest.raises(NotImplementedError):
        jax_attn.self_attention({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), jnp.asarray(pos), cfg=jcfg,
                                window=WINDOW, chunk=16)
    with pytest.raises(NotImplementedError, match="window"):
        port_attn.self_attention({k: torch.from_numpy(v)
                                  for k, v in p.items()},
                                 torch.from_numpy(x), torch.from_numpy(pos),
                                 cfg=cfg, window=WINDOW, chunk=16)
    jcfg, cfg, p, x, pos = _inputs(24, seed=8)
    want = jax_attn.self_attention({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x), jnp.asarray(pos),
                                   cfg=jcfg, window=WINDOW, chunk=16)
    got = port_attn.self_attention({k: torch.from_numpy(v)
                                    for k, v in p.items()},
                                   torch.from_numpy(x),
                                   torch.from_numpy(pos), cfg=cfg,
                                   window=WINDOW, chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_ring_decode_matches_reference_over_two_wraps():
    """20 decode positions against a ring of 8 rows from zeros: each
    step's output and the whole ring (K and V) equal to the reference's
    within 1e-5; the ring wraps at positions 8 and 16."""
    jcfg, cfg, p, _, _ = _inputs(4, seed=9)
    rng = np.random.default_rng(10)
    b, g, e = 2, cfg.num_kv_heads, cfg.head_dim
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jcache = {k: jnp.zeros((b, WINDOW, g, e), jnp.float32) for k in "kv"}
    cache = {k: torch.zeros((b, WINDOW, g, e)) for k in "kv"}
    for t in range(20):
        x = rng.standard_normal((b, 1, cfg.d_model), dtype=np.float32)
        pos = np.full((b,), t, np.int32)
        want, jcache = jax_attn.decode_self_attention(
            jp, jnp.asarray(x), jnp.asarray(pos), jcache, cfg=jcfg,
            window=WINDOW)
        got, back = port_attn.decode_self_attention(
            tp, torch.from_numpy(x), torch.from_numpy(pos), cache, cfg=cfg,
            window=WINDOW)
        assert back is cache                       # updated in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        for k in "kv":
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(jcache[k]), rtol=1e-5,
                                       atol=1e-5)
    with pytest.raises(ValueError, match="ring"):   # a ring of other rows
        port_attn.decode_self_attention(
            tp, torch.zeros((b, 1, cfg.d_model)), torch.zeros(
                b, dtype=torch.int32), cache, cfg=cfg, window=WINDOW + 1)


@pytest.mark.parametrize("window", [1, 3, 8])
def test_reference_ring_mask_is_a_prefix(window):
    """The reference's ring mask: slot t holds the largest position p <=
    pos with p % W == t, valid when p >= 0 and pos - p < W. For every pos
    < 3W that is exactly the slots t < min(pos + 1, W), the lengths the
    port hands ``decode_attention``."""
    t_idx = np.arange(window)[None, :]
    pos = np.arange(3 * window)[:, None]
    slot = pos % window
    delta = (slot - t_idx) % window
    abs_pos = pos - delta
    valid = (abs_pos >= 0) & (pos - abs_pos < window)
    np.testing.assert_array_equal(valid,
                                  t_idx < np.minimum(pos + 1, window))
