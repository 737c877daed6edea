"""The port's attention against the JAX package's, on the CPU.

* The plain versions of the two attention kernels (the port's
  ``kernels/ref.py``, which its wrappers run on CPU tensors) against the
  reference's Pallas kernels run in interpret mode (``repro.kernels.ops``).
* The port's ``self_attention`` / ``decode_self_attention`` against
  ``repro.models.attention``'s at float32, on a reduced qwen2 layer with
  non-zero QKV biases.

Tolerances are the reference's own for its kernels (2e-5 in float32,
2e-2 in bfloat16): the sums run in another order, never the arithmetic
otherwise. Inputs come from numpy with a seed and are handed to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.models import attention as jax_attn
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops as port_ops
from repro_torch.models import attention as port_attn

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype: str) -> float:
    return 2e-5 if dtype == "float32" else 2e-2


def _pair(a: np.ndarray, dtype: str):
    """One numpy array as the reference's and the port's input, rounded to
    ``dtype`` alike."""
    j = jnp.asarray(a).astype(dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TORCH_DTYPE[dtype])


@pytest.mark.parametrize("b,h,g,s,d,block", [
    (1, 4, 2, 128, 128, 128),      # GQA 2:1 (the reference's sweep)
    (2, 4, 4, 256, 128, 128),      # MHA
    (1, 8, 1, 128, 256, 128),      # MQA, the wide head
    (2, 4, 2, 80, 64, 16),         # S not a multiple of the card's 64 rows
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_reference_kernel(b, h, g, s, d, block,
                                                        causal, dtype):
    rng = np.random.default_rng(b * h * s + d)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal(shape, dtype=np.float32), dtype)
        for shape in ((b, h, s, d), (b, g, s, d), (b, g, s, d)))
    want = jax_ops.flash_attention(jq, jk, jv, causal=causal, block_q=block,
                                   block_k=block)
    before = port_ops.launch_counts()
    got = port_ops.flash_attention(tq, tk, tv, causal=causal)
    assert port_ops.launch_counts() == before        # CPU: the plain version
    assert got.dtype == TORCH_DTYPE[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=_tol(dtype), atol=_tol(dtype))


@pytest.mark.parametrize("b,h,g,s,d,block", [
    (2, 8, 2, 1024, 128, 512),     # the reference's sweep
    (1, 4, 4, 512, 128, 128),
    (3, 2, 1, 2048, 256, 512),
    (2, 4, 2, 256, 64, 128),       # the reduced configs' head dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_reference_kernel(b, h, g, s, d, block,
                                                         dtype):
    rng = np.random.default_rng(b * h + s)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal(shape, dtype=np.float32), dtype)
        for shape in ((b, h, d), (b, s, g, d), (b, s, g, d)))
    lengths = rng.integers(1, s + 1, size=b).astype(np.int32)
    lengths[0] = 1
    want = jax_ops.decode_attention(jq, jk, jv, jnp.asarray(lengths),
                                    block_k=block)
    got = port_ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=_tol(dtype), atol=_tol(dtype))


def test_decode_attention_poisoned_tail():
    """Only the first ``length`` cache rows count: a tail of 1e6 changes
    nothing, on either package."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 2, 128), dtype=np.float32)
    k = rng.standard_normal((1, 512, 1, 128), dtype=np.float32)
    v = rng.standard_normal((1, 512, 1, 128), dtype=np.float32)
    kp, vp = k.copy(), v.copy()
    kp[:, 10:], vp[:, 10:] = 1e6, 1e6
    lengths = np.array([10], np.int32)
    want = np.asarray(jax_ops.decode_attention(q, kp, vp, lengths))
    clean = port_ops.decode_attention(*map(torch.from_numpy, (q, k, v,
                                                               lengths)))
    poisoned = port_ops.decode_attention(*map(torch.from_numpy, (q, kp, vp,
                                                                  lengths)))
    assert torch.equal(clean, poisoned)
    np.testing.assert_allclose(poisoned.numpy(), want, rtol=2e-5, atol=2e-5)


def test_decode_attention_refuses_empty_and_overlong_lengths():
    q, k = torch.zeros(2, 2, 64), torch.zeros(2, 8, 1, 64)
    for bad in ([0, 3], [3, 9]):
        with pytest.raises(ValueError, match="lengths must lie"):
            port_ops.decode_attention(q, k, k, torch.tensor(bad))


def _layer(cfg, rng) -> dict:
    """One attention layer's parameters, biases and all non-zero."""
    d, h, g, e = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": (d, h, e), "wk": (d, g, e), "wv": (d, g, e),
              "wo": (h, e, d), "bq": (h, e), "bk": (g, e), "bv": (g, e)}
    return {k: (rng.standard_normal(s, dtype=np.float32)
                * (0.5 if k[0] == "b" else s[0] ** -0.5))
            for k, s in shapes.items()}


def _cfg():
    return reduced(get_config("qwen2-1.5b"), layers_per_segment=2)


@pytest.mark.parametrize("s,chunk", [(16, 1024), (40, 1024), (40, 16)])
def test_self_attention_matches_reference(s, chunk):
    """Full attention (S <= chunk) and the chunked online softmax alike."""
    cfg = _cfg()
    rng = np.random.default_rng(s + chunk)
    p = _layer(cfg, rng)
    x = rng.standard_normal((2, s, cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    want = jax_attn.self_attention({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x), jnp.asarray(pos), cfg=cfg,
                                   chunk=chunk)
    got = port_attn.self_attention(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        torch.from_numpy(pos.copy()), cfg=cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_decode_self_attention_matches_reference():
    """Output and written cache rows, from a seeded cache at mixed
    positions (0 is the first row, the last is the cache's end)."""
    cfg = _cfg()
    rng = np.random.default_rng(5)
    p = _layer(cfg, rng)
    b, s_cache = 3, 12
    x = rng.standard_normal((b, 1, cfg.d_model), dtype=np.float32)
    pos = np.array([0, 5, s_cache - 1], np.int32)
    cache = {k: rng.standard_normal((b, s_cache, cfg.num_kv_heads,
                                     cfg.head_dim), dtype=np.float32)
             for k in ("k", "v")}
    want, want_cache = jax_attn.decode_self_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(pos), {k: jnp.asarray(v) for k, v in cache.items()},
        cfg=cfg)
    port_cache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, got_cache = port_attn.decode_self_attention(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        torch.from_numpy(pos), port_cache, cfg=cfg)
    assert got_cache is port_cache                     # updated in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(got_cache[k].numpy(),
                                   np.asarray(want_cache[k]), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("mode", ["window", "int8 cache"])
def test_unported_attention_modes_raise(mode):
    """What still raises: a windowed layer past one chunk whose S is no
    multiple of the window (``NotImplementedError``, as the reference);
    an int8 cache without its ``v_scale`` (``KeyError`` in both
    packages; the int8 cache itself is ported, ``test_torch_kv_int8``,
    and a whole one decodes)."""
    cfg = _cfg()
    rng = np.random.default_rng(1)
    layer = _layer(cfg, rng)
    p = {k: torch.from_numpy(v) for k, v in layer.items()}
    x = torch.zeros(1, 4, cfg.d_model)
    pos = torch.arange(4)[None]
    if mode == "window":            # past one chunk, S % window != 0
        with pytest.raises(NotImplementedError):
            port_attn.self_attention(p, x, pos, cfg=cfg, window=3, chunk=2)
        return
    shp = (1, 4, cfg.num_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shp, dtype=torch.int8),
             "v": torch.zeros(shp, dtype=torch.int8),
             "k_scale": torch.zeros(*shp[:-1], 1)}
    zero = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(KeyError, match="v_scale"):
        port_attn.decode_self_attention(p, x[:, :1], zero, cache, cfg=cfg)
    with pytest.raises(KeyError, match="v_scale"):
        jax_attn.decode_self_attention(
            {k: jnp.asarray(v) for k, v in layer.items()},
            jnp.zeros((1, 1, cfg.d_model)), jnp.zeros(1, jnp.int32),
            {k: jnp.asarray(v.numpy()) for k, v in cache.items()}, cfg=cfg)
    cache["v_scale"] = torch.zeros(*shp[:-1], 1)
    out, _ = port_attn.decode_self_attention(p, x[:, :1], zero, cache,
                                             cfg=cfg)
    assert out.shape == (1, 1, cfg.d_model) and cache["k"].dtype == torch.int8
