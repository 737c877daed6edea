"""The port's int8 KV cache against the JAX package's, on the CPU.

``init_cache(kv_quant=True)`` keeps a global or sliding-window layer's
K/V rows as int8 codes with one float32 absmax scale a (token, head)
row; ``decode_self_attention`` quantizes each new row with
``_quantize_row`` and reads the cache back through ``dequantize_rows``
(its plain version on CPU tensors) before ``decode_attention``.

Tolerances, with what was measured when they were set:

* ``_quantize_row``: codes and scales bit-equal to the reference's as
  its jitted decode computes them (XLA folds ``/ 127.0`` into a multiply
  by ``f32(1 / 127)``; JAX's op-by-op dispatch divides, and the two
  scales differ in the last bit for 3.5% of random rows), on rows with
  zeros, exact ties at .5 and an absmax under 1e-6, in float32 and
  bfloat16. For a bf16 row XLA keeps the scale it returns in float32
  and divides by the scale's bf16 rounding in bf16; a scale rounded to
  bf16 before it is returned (as torch's bf16 ops would) leaves the
  codes equal but 262 of the 268 scales apart.
* One attention layer decoding S steps against an int8 cache, global
  and ring: the V codes and scales bit-equal to the reference's jitted
  layer (V rows are projections, bit-equal in both packages); the K
  codes bit-equal and the K scales within 2 ulp (measured: 2 ulp at
  most, in 24 of 96 rows; the ring 1 ulp in 13 of 48). K is rotated
  first, and the port's rope (torch's ``pow``, ``cos``, ``sin``) and
  XLA's differ in the last bit, so the absmax that sets a K scale may
  too; the layer's output within 1e-5. The same layer in bfloat16:
  caches bit-equal (K scales held to the same 2 ulp), the output within
  2e-2 (measured 1.95e-3).
* A whole reduced model decoding 12 steps with the int8 cache, float32:
  logits within rtol = atol = 1e-4 of the reference's (measured 1.81e-5
  on qwen2-7b, 7.37e-5 on jamba); every code within 1 (measured: none
  apart) and every scale within rtol 1e-4 (123 and 31 scales not
  bit-equal: the rows carry the float32 rounding of the layers before).
* Decode against forward with the int8 cache, 24 steps, both packages
  on the same params: qwen2-7b and gemma3-4b (a ring of 16 rows that
  wraps) under the reference's own bound of 0.3
  (``tests/test_perf_features.py``; measured 0.0561 and 0.0726 in
  both); jamba-1.5-large-398b within twice the reference's own
  divergence, which is past 0.3 (1.12 in both; see the test).
* The dequantize: keys and values equal to the reference's
  ``cache.astype(q.dtype) * scale.astype(q.dtype)`` and ``f32(cache) *
  scale``, in float32 and bfloat16 (codes have 7 bits, a bf16 scale 8,
  so the float32 product is exact and rounds to the reference's bf16
  product).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attention
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro_torch.convert import load_lm_params
from repro_torch.kernels import ops as port_ops
from repro_torch.models import attention, decode_step, forward, init_cache
from test_torch_lm import _cfgs, _params

JAMBA = "jamba-1.5-large-398b"
_jax_quantize_row = jax.jit(jax_attention._quantize_row)


def _special_rows(rng) -> np.ndarray:
    """(B, Kv, hd) float32 rows that exercise the quantizer's edges: an
    all-zero row, rows with zeros, rows whose absmax is under the 1e-6
    clamp, rows where x / scale falls on exact ties at .5 (absmax 127 *
    2^k, so the scale is a power of two times f32(127 / 127)), and
    random rows over twenty decades."""
    hd = 64
    rows = [np.zeros(hd, np.float32)]
    z = rng.standard_normal(hd).astype(np.float32)
    z[::3] = 0.0
    rows.append(z)
    rows.append((rng.standard_normal(hd) * 1e-8).astype(np.float32))
    rows.append((rng.standard_normal(hd) * 3e-7).astype(np.float32))
    for k in (-3, 0, 5):
        t = (np.arange(hd) % 8 - 3.5).astype(np.float32)      # k + .5 ties
        t[0] = 127.0
        rows.append(t * np.float32(2.0 ** k))
        rows.append(-t * np.float32(2.0 ** k))
    while len(rows) % 4:
        rows.append(rng.standard_normal(hd).astype(np.float32))
    special = np.stack(rows).reshape(-1, 4, hd)
    wide = (rng.standard_normal((64, 4, hd))
            * np.exp(rng.uniform(-30, 15, (64, 4, 1)))).astype(np.float32)
    return np.concatenate([special, wide])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_row_bit_equal_to_reference(dtype):
    jx = jnp.asarray(_special_rows(np.random.default_rng(0))).astype(
        getattr(jnp, dtype))
    want_q, want_s = (np.asarray(a) for a in _jax_quantize_row(jx))
    x = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got_q, got_s = attention._quantize_row(x)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert got_s.shape == (*x.shape[:-1], 1)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    # the edges were hit: a zero row, clamped scales, codes at +-127,
    # exact ties at .5 (of x over the scale in x's dtype)
    assert (got_q.numpy()[0, 0] == 0).all()
    ratio = (x / got_s.to(x.dtype)).float().numpy()
    assert (ratio - np.floor(ratio) == 0.5).any()
    floor = np.float32(torch.tensor(1e-6, dtype=x.dtype).item())
    assert (got_s.numpy() == floor * np.float32(1 / 127)).any()
    assert np.abs(got_q.numpy()).max() == 127


def test_init_cache_int8_entries():
    """Attention and ring positions get int8 ``k`` / ``v`` and float32
    scales of shape (..., Kv, 1), as the reference's; Mamba and cross
    entries stay as they are."""
    for arch in (JAMBA, "gemma3-4b", "whisper-medium"):
        jcfg, cfg = _cfgs(arch)
        want = jax_init_cache(jcfg, 2, 24, dtype=jnp.float32, kv_quant=True)
        got = init_cache(cfg, 2, 24, dtype=torch.float32, device="cpu",
                         kv_quant=True)
        for seg, jseg in zip(got["segments"], want["segments"]):
            assert sorted(seg) == sorted(jseg)
            for pos, entry in seg.items():
                assert sorted(entry) == sorted(jseg[pos])
                for k, v in entry.items():
                    assert v.shape == jseg[pos][k].shape, (arch, pos, k)
                    assert str(v.dtype)[6:] == str(jseg[pos][k].dtype), (
                        arch, pos, k)
                    assert not v.any()


def _layer_params(cfg, rng) -> dict:
    d, h, g, e = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
            for k, s in (("wq", (d, h, e)), ("wk", (d, g, e)),
                         ("wv", (d, g, e)), ("wo", (h, e, d)))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 8])
def test_layer_decode_int8_cache_matches_reference(window, dtype):
    """One attention layer decoding 16 steps of the same inputs against
    an int8 cache (a 16-row cache, or a ring of 8 rows that wraps twice),
    its params and inputs in ``dtype``: the caches as the module
    docstring says, the outputs within 1e-5 in float32 and 2e-2 in
    bfloat16 (measured 1.95e-3, caches bit-equal)."""
    jcfg, cfg = _cfgs("qwen2-7b")
    rng = np.random.default_rng(1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    jp = {k: jnp.asarray(v).astype(jdt)
          for k, v in _layer_params(cfg, rng).items()}
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(tdt)
          for k, v in jp.items()}
    b, steps = 3, 16
    rows = window or steps
    g, e = cfg.num_kv_heads, cfg.head_dim
    shp = (b, rows, g, e)
    jcache = {"k": jnp.zeros(shp, jnp.int8), "v": jnp.zeros(shp, jnp.int8),
              "k_scale": jnp.zeros(shp[:-1] + (1,), jnp.float32),
              "v_scale": jnp.zeros(shp[:-1] + (1,), jnp.float32)}
    cache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    jstep = jax.jit(lambda c, x, pos: jax_attention.decode_self_attention(
        jp, x, pos, c, cfg=jcfg, window=window))
    worst = 0.0
    for t in range(steps):
        jx = jnp.asarray(rng.standard_normal((b, 1, cfg.d_model))).astype(
            jdt)
        pos = np.full((b,), t, np.int32)
        want, jcache = jstep(jcache, jx, jnp.asarray(pos))
        want = np.asarray(want.astype(jnp.float32))
        got, cache2 = attention.decode_self_attention(
            tp, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt),
            torch.from_numpy(pos), cache, cfg=cfg, window=window)
        assert cache2 is cache and got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)
        worst = max(worst, float(np.abs(got.float().numpy() - want).max()))
    for k in ("k", "v", "v_scale"):
        np.testing.assert_array_equal(cache[k].numpy(), np.asarray(jcache[k]))
    ks, jks = cache["k_scale"].numpy(), np.asarray(jcache["k_scale"])
    ulps = np.abs(ks.view(np.int32) - jks.view(np.int32))
    print(f"{dtype} window {window}: outputs within {worst:.3g}; K scales "
          f"off by at most {ulps.max()} ulp in {(ulps > 0).sum()} of "
          f"{ulps.size} rows")
    assert ulps.max() <= 2


@pytest.mark.parametrize("arch", ["qwen2-7b", JAMBA])
def test_model_decode_int8_cache_matches_reference(arch):
    """A reduced model decoding 12 steps from an empty int8 cache, float32:
    logits within 1e-4 of the reference's jitted ``decode_step``. The rows
    that reach a cache carry the float32 rounding of the layers before it
    (in the first layer, RMSNorm's), so a code may sit one apart where
    its row lands near a tie and a scale differ in its last bits: codes
    within 1 and scales within rtol 1e-4, the counts printed."""
    jcfg, cfg = _cfgs(arch)
    tree = _params(jcfg, 3)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = load_lm_params(cfg, tree, device="cpu")
    b, steps = 2, 12
    jcache = jax_init_cache(jcfg, b, steps, dtype=jnp.float32, kv_quant=True)
    cache = init_cache(cfg, b, steps, dtype=torch.float32, device="cpu",
                       kv_quant=True)
    jstep = jax.jit(lambda c, t, pos: jax_decode_step(jparams, jcfg, c, t,
                                                      pos))
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (steps, b, 1)).astype(np.int32)
    before = port_ops.launch_counts()
    worst = 0.0
    for t in range(steps):
        pos = np.full((b,), t, np.int32)
        want, jcache = jstep(jcache, jnp.asarray(toks[t]), jnp.asarray(pos))
        got, cache = decode_step(params, cfg, cache,
                                 torch.from_numpy(toks[t]),
                                 torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
        worst = max(worst, float(np.abs(got.numpy() - np.asarray(want))
                                 .max()))
    assert port_ops.launch_counts() == before           # plain versions
    flips = scaled = 0
    for seg, jseg in zip(cache["segments"], jcache["segments"]):
        for pos, entry in seg.items():
            if "k_scale" not in entry:
                continue
            for k in ("k", "v"):
                codes = entry[k].numpy().astype(np.int32)
                apart = np.abs(codes - np.asarray(jseg[pos][k]))
                assert apart.max() <= 1
                flips += int((apart > 0).sum())
                np.testing.assert_allclose(
                    entry[k + "_scale"].numpy(),
                    np.asarray(jseg[pos][k + "_scale"]), rtol=1e-4, atol=0)
                scaled += int((entry[k + "_scale"].numpy()
                               != np.asarray(jseg[pos][k + "_scale"])).sum())
    print(f"{arch}: int8-cache logits within {worst:.3g} of the "
          f"reference; {flips} codes one apart, {scaled} scales not "
          f"bit-equal")


def _int8_divergence(full, cfg, tokens, decode) -> float:
    """The largest |logit| difference over the real vocabulary between
    ``decode``, a function of (cache, tokens (B, 1), pos (B,)) returning
    ``(logits, cache)`` that starts an empty int8 cache when given None,
    stepped over ``tokens`` (B, S), and the forward's logits ``full``
    (B, S, V)."""
    b, s = tokens.shape
    worst = 0.0
    cache = None
    for t in range(s):
        logits, cache = decode(cache, tokens[:, t:t + 1],
                               np.full((b,), t, np.int32))
        worst = max(worst, float(np.abs(np.asarray(logits)
                                        - full[:, t])[
            :, :cfg.vocab_size].max()))
    return worst


@pytest.mark.parametrize("arch", ["qwen2-7b", JAMBA, "gemma3-4b"])
def test_int8_decode_close_to_forward(arch):
    """As the reference's ``tests/test_perf_features.py`` holds its own: 24
    decode steps from an empty int8 cache against one float32 forward over
    the same tokens, both packages on the reference's ``init_params`` from
    key 1, as that test draws them (a MoE's capacity
    factor raised to 8 so the forward drops no token; gemma3's ring of 16
    rows wraps). qwen2-7b and gemma3-4b stay under the reference's 0.3.
    jamba does not, in the reference either: its one attention layer
    feeds seven Mamba layers, whose states carry a token's int8 error to
    every later token, and four top-2 MoE layers, where it flips routes
    (the reference's own divergence on its params from keys 1-3 and its
    test's tokens: 1.04, 0.71, 0.63; here 1.12, the port's too). There
    the port's divergence is held within twice the reference's own on the
    same params and tokens."""
    jcfg, cfg = _cfgs(arch)
    if cfg.num_experts:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=8.0)
        cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    params = load_lm_params(cfg, jax.tree.map(np.asarray, jparams),
                            device="cpu")
    b, s = 2, 24
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    full, _ = forward(params, cfg, torch.from_numpy(tokens))
    jfull, _ = jax_forward(jparams, jcfg, jnp.asarray(tokens))
    jstep = jax.jit(lambda c, t, pos: jax_decode_step(jparams, jcfg, c, t,
                                                      pos))

    def port_decode(cache, tok, pos):
        if cache is None:
            cache = init_cache(cfg, b, s, dtype=torch.float32, device="cpu",
                               kv_quant=True)
        logits, cache = decode_step(params, cfg, cache,
                                    torch.from_numpy(tok),
                                    torch.from_numpy(pos))
        return logits.numpy(), cache

    def ref_decode(cache, tok, pos):
        if cache is None:
            cache = jax_init_cache(jcfg, b, s, dtype=jnp.float32,
                                   kv_quant=True)
        return jstep(cache, jnp.asarray(tok), jnp.asarray(pos))

    got = _int8_divergence(full.numpy(), cfg, tokens, port_decode)
    want = _int8_divergence(np.asarray(jfull), cfg, tokens, ref_decode)
    print(f"{arch}: int8 decode/forward divergence, port {got:.3g}, "
          f"reference {want:.3g}")
    if arch == JAMBA:
        assert got <= 2 * want
    else:
        assert got < 0.3 and want < 0.3
    cache = port_decode(None, tokens[:, :1], np.zeros(b, np.int32))[1]
    kv = [e for seg in cache["segments"] for e in seg.values() if "k" in e]
    assert kv and all(e["k"].dtype == torch.int8 for e in kv)
    if cfg.window_size:
        assert min(e["k"].shape[2] for e in kv) == cfg.window_size < s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_equals_reference_keys_and_values(dtype):
    """The plain path of ``attention._dequantize``: keys on the scale
    rounded to q's dtype with the product rounded back, values in
    float32 — the reference's ``keys`` and ``values`` bit for bit."""
    rng = np.random.default_rng(5)
    codes = rng.integers(-127, 128, (2, 40, 4, 64)).astype(np.int8)
    scale = (np.exp(rng.uniform(-20, 5, (2, 40, 4, 1)))).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want_k = np.asarray(jnp.asarray(codes).astype(jdt)
                        * jnp.asarray(scale).astype(jdt)).astype(np.float32)
    want_v = np.asarray(jnp.asarray(codes).astype(jnp.float32)
                        * jnp.asarray(scale))
    c, s = torch.from_numpy(codes), torch.from_numpy(scale)
    keys = attention._dequantize(c, s.to(tdt)).to(tdt)
    values = attention._dequantize(c, s)
    assert keys.dtype == tdt and values.dtype == torch.float32
    np.testing.assert_array_equal(keys.float().numpy(), want_k)
    np.testing.assert_array_equal(values.numpy(), want_v)
