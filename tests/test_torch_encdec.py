"""The port's encoder and cross attention against the JAX package's, on
the CPU, on ``reduced(get_config("whisper-medium"))`` (d_model 256, 4
heads of 64 over 2 KV groups: GQA with 2 heads a group) with
``encoder_len`` 23, so T is no multiple of a tile, and on reduced
llama-3.2-vision-90b, whose context reaches its cross layers without an
encoder.

Layer by layer: ``self_attention(causal=False)`` over T = 23 frames,
``cross_attention`` of S = 5 queries against T = 23 frames (with and
without QKV biases) and ``decode_cross_attention`` against a (B, 23, Kv,
hd) cross cache, each within 1e-5 of the reference's in float32 (2e-2
in bfloat16) and of a float64 NumPy oracle written from the definition;
the gradients of both non-causal modes against ``jax.grad`` within 1e-4
of each one's largest magnitude. Then the model: ``encode``,
``precompute_cross_cache`` (``xk`` and ``xv`` within 2e-5, the float32
floor measured against a float64 run), ``forward``
with ``enc_context`` (logits within rtol = atol = 1e-4), and a
``ServeDriver`` hot swap, which leaves the cross cache as it was
computed, as the reference's does. The reference's parameters are
carried across with ``convert.load_lm_params``.

Inputs come from numpy with a seed and are handed to both packages.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import attention as jax_attn
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import precompute_cross_cache as jax_precompute
from repro.models.model import encode as jax_encode
from repro.serving.predictor import ServeDriver as JaxServeDriver
from repro.serving.predictor import make_serve_step as jax_make_serve_step
from repro_torch.configs import get_config, reduced
from repro_torch.convert import load_lm_params
from repro_torch.kernels import ops as port_ops
from repro_torch.models import attention as port_attn
from repro_torch.models import (encode, forward, init_cache, init_params,
                                precompute_cross_cache)
from repro_torch.serving.predictor import ServeDriver, make_serve_step

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import _tree_map as tree_map  # noqa: E402
from chip_smoke import float64_math  # noqa: E402

FRAMES = 23                     # T: no multiple of the kernels' tiles
QUERIES = 5                     # S of the cross attention
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ARCHS = ["whisper-medium", "llama-3.2-vision-90b"]
# The cross cache against the reference's: whisper's K/V come out of the
# encoder, and there the reference's own float32 ``xk`` and ``xv`` lie up
# to 2.01 tolerances of rtol = atol = 1e-5 from a float64 run of the same
# params (0.98 after one encoder layer), the port's 1.76, while the two
# differ by 1.18. So they are held at twice 1e-5, each leaf's distance
# from float64 within twice the reference's.
CROSS_CACHE_TOL = 2e-5


def _cfgs(arch: str = "whisper-medium", layers: int = 1):
    """Both packages' reduced configs of ``arch`` at ``encoder_len``
    ``FRAMES``, the port's equal to the reference's."""
    jcfg = dataclasses.replace(
        jax_reduced(jax_get_config(arch), layers_per_segment=layers),
        encoder_len=FRAMES)
    cfg = dataclasses.replace(
        reduced(get_config(arch), layers_per_segment=layers),
        encoder_len=FRAMES)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)   # a copy
    return jcfg, cfg


def _layer(cfg, rng, bias: bool = False) -> dict:
    """One attention layer's parameters at the model's init scale (the
    variance 1 / fan-in), with N(0, 0.1) QKV biases if ``bias``."""
    d, h, g, e = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": ((d, h, e), d), "wk": ((d, g, e), d),
              "wv": ((d, g, e), d), "wo": ((h, e, d), h * e)}
    p = {k: rng.standard_normal(s, dtype=np.float32) * fan ** -0.5
         for k, (s, fan) in shapes.items()}
    if bias:
        for k, n in (("bq", h), ("bk", g), ("bv", g)):
            p[k] = 0.1 * rng.standard_normal((n, e), dtype=np.float32)
    return p


def _both(a: np.ndarray, dtype: str):
    """``a`` rounded to ``dtype``: as the reference's input, the port's,
    and as float64 numpy of the rounded values."""
    j = jnp.asarray(a).astype(dtype)
    f = np.array(j.astype(jnp.float32))
    return j, torch.from_numpy(f).to(TORCH_DTYPE[dtype]), f.astype(np.float64)


def _rope64(x: np.ndarray, pos: np.ndarray, theta: float) -> np.ndarray:
    """Rotary embedding on dimension halves, float64."""
    half = x.shape[-1] // 2
    ang = pos[..., None, None].astype(np.float64) * theta ** -(
        np.arange(half) / half)
    x1, x2 = x[..., :half], x[..., half:]
    return np.concatenate([x1 * np.cos(ang) - x2 * np.sin(ang),
                           x2 * np.cos(ang) + x1 * np.sin(ang)], axis=-1)


def oracle(cfg, p: dict, x: np.ndarray, kv_src: np.ndarray,
           pos=None) -> np.ndarray:
    """Unmasked GQA attention from its definition, in float64: queries
    from x (B, S, D), keys and values from ``kv_src`` (B, T, D); with
    ``pos`` (B, S = T) q and k rotated (the encoder's self-attention),
    else not (cross attention)."""
    h, g, e = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = np.einsum("bsd,dhe->bshe", x, p["wq"]) + p.get("bq", 0)
    k = np.einsum("btd,dge->btge", kv_src, p["wk"]) + p.get("bk", 0)
    v = np.einsum("btd,dge->btge", kv_src, p["wv"]) + p.get("bv", 0)
    if pos is not None:
        q, k = (_rope64(t, pos, cfg.rope_theta) for t in (q, k))
    kv = np.arange(h) // (h // g)                  # the KV group of a head
    scores = np.einsum("bshe,bthe->bhst", q, k[:, :, kv]) * e ** -0.5
    probs = np.exp(scores - scores.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.einsum("bhst,bthe->bshe", probs, v[:, :, kv])
    return np.einsum("bshe,hed->bsd", out, p["wo"])


def _hold(got: torch.Tensor, want, exact: np.ndarray, tol: float,
          what: str) -> None:
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    print(f"{what}: vs the reference {np.abs(got - want).max():.3g}, vs "
          f"float64 {np.abs(got - exact).max():.3g} (largest |out| "
          f"{np.abs(exact).max():.3g})")
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, exact, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_self_attention_matches_reference_and_oracle(dtype):
    """``self_attention(causal=False)`` over T = 23 frames: q and k
    rotated at ``arange(T)``, every frame attends every frame."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(1)
    p = {k: _both(v, dtype) for k, v in _layer(cfg, rng).items()}
    jx, tx, x64 = _both(rng.standard_normal((2, FRAMES, cfg.d_model),
                                            dtype=np.float32), dtype)
    pos = np.broadcast_to(np.arange(FRAMES, dtype=np.int32),
                          (2, FRAMES)).copy()
    want = jax_attn.self_attention({k: v[0] for k, v in p.items()}, jx,
                                   jnp.asarray(pos), cfg=jcfg, causal=False)
    before = port_ops.launch_counts()
    got = port_attn.self_attention({k: v[1] for k, v in p.items()}, tx,
                                   torch.from_numpy(pos), cfg=cfg,
                                   causal=False)
    assert port_ops.launch_counts() == before       # CPU: plain versions
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == tx.shape
    exact = oracle(cfg, {k: v[2] for k, v in p.items()}, x64, x64, pos)
    _hold(got, want, exact, TOL[dtype], f"encoder attention {dtype}")


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference_and_oracle(dtype, bias):
    """``cross_attention`` of S = 5 queries against T = 23 frames, GQA
    with 2 heads a group, no rotation."""
    jcfg, cfg = _cfgs()
    assert cfg.num_heads // cfg.num_kv_heads == 2
    rng = np.random.default_rng(2)
    p = {k: _both(v, dtype) for k, v in _layer(cfg, rng, bias).items()}
    jx, tx, x64 = _both(rng.standard_normal((3, QUERIES, cfg.d_model),
                                            dtype=np.float32), dtype)
    je, te, e64 = _both(rng.standard_normal((3, FRAMES, cfg.d_model),
                                            dtype=np.float32), dtype)
    want = jax_attn.cross_attention({k: v[0] for k, v in p.items()}, jx, je,
                                    cfg=jcfg)
    got = port_attn.cross_attention({k: v[1] for k, v in p.items()}, tx, te,
                                    cfg=cfg)
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == tx.shape
    exact = oracle(cfg, {k: v[2] for k, v in p.items()}, x64, e64)
    _hold(got, want, exact, TOL[dtype], f"cross attention {dtype}")


@pytest.mark.parametrize("bias", [False, True])
def test_decode_cross_attention_matches_reference(bias):
    """One token against a (B, 23, Kv, hd) cross cache: every frame
    valid; the cache is read, never written."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(3)
    p = _layer(cfg, rng, bias)
    b = 3
    x = rng.standard_normal((b, 1, cfg.d_model), dtype=np.float32)
    xk, xv = (rng.standard_normal((b, FRAMES, cfg.num_kv_heads,
                                   cfg.head_dim), dtype=np.float32)
              for _ in range(2))
    want = jax_attn.decode_cross_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(xk), jnp.asarray(xv), cfg=jcfg)
    tk, tv = torch.from_numpy(xk.copy()), torch.from_numpy(xv.copy())
    got = port_attn.decode_cross_attention(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        tk, tv, cfg=cfg)
    assert got.shape == x.shape
    np.testing.assert_array_equal(tk.numpy(), xk)
    np.testing.assert_array_equal(tv.numpy(), xv)
    # the oracle: the new token's query against the cached K and V
    h, g, e = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = np.einsum("bsd,dhe->bshe", x.astype(np.float64), p["wq"]) + \
        p.get("bq", 0)
    kv = np.arange(h) // (h // g)
    scores = np.einsum("bshe,bthe->bhst", q, xk[:, :, kv]) * e ** -0.5
    probs = np.exp(scores - scores.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    exact = np.einsum("bshe,hed->bsd", np.einsum(
        "bhst,bthe->bshe", probs, xv[:, :, kv]), p["wo"])
    _hold(got, want, exact, 1e-5, "decode cross attention")


@pytest.mark.parametrize("mode", ["encoder", "cross"])
def test_non_causal_grads_match_jax_grad(mode):
    """Gradients of ``sum(w * out)`` with respect to the queries' input,
    the frames (cross) and every weight and bias (cross), within 1e-4 of
    each one's largest magnitude: ``_FlashAttention``'s backward unmasked, at S = T
    = 23 and at S = 5 against T = 23 (dk and dv flowing back into the
    frames)."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(4)
    p = _layer(cfg, rng, bias=mode == "cross")
    s = FRAMES if mode == "encoder" else QUERIES
    x = rng.standard_normal((2, s, cfg.d_model), dtype=np.float32)
    enc = rng.standard_normal((2, FRAMES, cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    w = rng.standard_normal(x.shape, dtype=np.float32)

    def jloss(p, x, enc):
        if mode == "encoder":
            out = jax_attn.self_attention(p, x, jnp.asarray(pos), cfg=jcfg,
                                          causal=False)
        else:
            out = jax_attn.cross_attention(p, x, enc, cfg=jcfg)
        return (out * jnp.asarray(w)).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(enc))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx, te = (torch.from_numpy(a).requires_grad_(True) for a in (x, enc))
    if mode == "encoder":
        out = port_attn.self_attention(tp, tx, torch.from_numpy(pos),
                                       cfg=cfg, causal=False)
    else:
        out = port_attn.cross_attention(tp, tx, te, cfg=cfg)
    (out * torch.from_numpy(w)).sum().backward()
    pairs = [("x", tx.grad, jg[1])] + [(k, tp[k].grad, jg[0][k]) for k in p]
    if mode == "cross":
        pairs.append(("enc", te.grad, jg[2]))
    else:
        assert te.grad is None
    largest = max(float(np.abs(np.asarray(w)).max()) for *_, w in pairs)
    for name, got, want in pairs:
        want = np.asarray(want)
        # bk's gradient is zero: one bias on every key shifts all of a
        # query's scores alike, which the softmax cancels; it is held
        # against the largest gradient of the layer
        scale = largest if name == "bk" else np.abs(want).max()
        dev = np.abs(got.numpy() - want).max() / scale
        assert dev <= 1e-4, (name, dev)


def _params(jcfg, seed: int):
    """The reference's parameters with every leaf perturbed, as numpy."""
    rng = np.random.default_rng(seed)
    tree = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
            a.shape, dtype=np.float32), tree)


def _frames(cfg, batch: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.encoder_len, cfg.d_model), dtype=np.float32)


def test_encode_matches_reference():
    """Two encoder layers over 23 frames, then the final norm."""
    jcfg, cfg = _cfgs(layers=2)
    tree = _params(jcfg, 5)
    frames = _frames(cfg, 2, 6)
    want = jax_encode(jax.tree.map(jnp.asarray, tree), jcfg,
                      jnp.asarray(frames))
    got = encode(load_lm_params(cfg, tree, device="cpu"), cfg,
                 torch.from_numpy(frames))
    assert got.shape == frames.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_precompute_cross_cache_matches_reference(arch):
    """Every cross position's ``xk`` and ``xv``, filled in place, within
    ``CROSS_CACHE_TOL`` of the reference's, two layers a segment; the
    self-attention entries stay zero. Both against a float64 run of the
    port (``float64_math``): the port's distance within twice the
    reference's own (``pytest -s`` prints both)."""
    jcfg, cfg = _cfgs(arch, layers=2)
    tree = _params(jcfg, 7)
    frames = _frames(cfg, 2, 8)
    want = jax_precompute(jax.tree.map(jnp.asarray, tree), jcfg,
                          jax_init_cache(jcfg, 2, 8, dtype=jnp.float32),
                          jnp.asarray(frames))
    params = load_lm_params(cfg, tree, device="cpu")
    cache = init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    got = precompute_cross_cache(params, cfg, cache, torch.from_numpy(frames))
    assert got is cache
    with float64_math():
        exact = precompute_cross_cache(
            tree_map(lambda t: t.double(), params),
            dataclasses.replace(cfg, dtype="float64", param_dtype="float64"),
            init_cache(cfg, 2, 8, dtype=torch.float64, device="cpu"),
            torch.from_numpy(frames).double())
    cross, floor = 0, [0.0, 0.0]
    for seg, jseg, xseg in zip(got["segments"], want["segments"],
                               exact["segments"]):
        assert sorted(seg) == sorted(jseg)
        for i, entry in seg.items():
            assert sorted(entry) == sorted(jseg[i])
            for k, v in entry.items():
                assert v.shape == jseg[i][k].shape and not v.requires_grad
                if k not in ("xk", "xv"):
                    assert not v.any()
                    continue
                cross += 1
                w, x = np.asarray(jseg[i][k]), xseg[i][k].numpy()
                np.testing.assert_allclose(v.numpy(), w,
                                           rtol=CROSS_CACHE_TOL,
                                           atol=CROSS_CACHE_TOL)
                for j, a in enumerate((w, v.numpy())):
                    floor[j] = max(floor[j], float(np.abs(a - x).max()))
    print(f"{arch}: xk, xv vs float64: reference {floor[0]:.3g}, port "
          f"{floor[1]:.3g}")
    assert cross == 2
    assert floor[1] <= 2 * floor[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_context_matches_reference(arch):
    """Logits over 7 tokens with 23 frames of context: the encoder's
    states (whisper) or the frames as they are (llama-vision)."""
    from repro.models import forward as jax_forward
    jcfg, cfg = _cfgs(arch)
    tree = _params(jcfg, 9)
    frames = _frames(cfg, 2, 10)
    tokens = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (2, 7)).astype(np.int32)
    want, _ = jax_forward(jax.tree.map(jnp.asarray, tree), jcfg,
                          jnp.asarray(tokens), enc_context=jnp.asarray(frames))
    got, _ = forward(load_lm_params(cfg, tree, device="cpu"), cfg,
                     torch.from_numpy(tokens),
                     enc_context=torch.from_numpy(frames))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_context_must_match_the_config():
    """A model with context refuses a forward without one (or of another
    width); a decoder-only model refuses one."""
    _, cfg = _cfgs()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="enc_context"):
        forward(params, cfg, tokens)
    with pytest.raises(ValueError, match="enc_context"):
        forward(params, cfg, tokens, enc_context=torch.zeros(1, FRAMES, 8))
    qwen = reduced(get_config("qwen2-1.5b"))
    with pytest.raises(ValueError, match="takes no enc_context"):
        forward(init_params(qwen, torch.Generator().manual_seed(0)), qwen,
                tokens, enc_context=torch.zeros(1, FRAMES, qwen.d_model))


def test_load_lm_params_checks_the_encoder():
    """The encoder subtree is carried leaf for leaf; a missing one, an
    extra key in it or a leaf not stacked on its repeats raises."""
    jcfg, cfg = _cfgs(layers=2)
    tree = _params(jcfg, 12)
    params = load_lm_params(cfg, tree, device="cpu")
    assert sorted(params["encoder"]) == ["final_norm", "segments"]
    wq = params["encoder"]["segments"][0]["pos0"]["mixer"]["wq"]
    np.testing.assert_array_equal(
        wq.numpy(), tree["encoder"]["segments"][0]["pos0"]["mixer"]["wq"])
    with pytest.raises(ValueError, match="parameter keys"):
        load_lm_params(cfg, {k: v for k, v in tree.items()
                             if k != "encoder"}, device="cpu")
    with pytest.raises(ValueError, match="encoder keys"):
        load_lm_params(cfg, {**tree, "encoder": {**tree["encoder"],
                                                 "extra": 0}}, device="cpu")
    seg = tree["encoder"]["segments"][0]
    cut = {**seg, "pos0": {**seg["pos0"], "mixer": {
        **seg["pos0"]["mixer"], "wq": seg["pos0"]["mixer"]["wq"][:1]}}}
    with pytest.raises(ValueError, match="stacked"):
        load_lm_params(cfg, {**tree, "encoder": {**tree["encoder"],
                                                 "segments": [cut]}},
                       device="cpu")


def _recording(step_fn, log: list):
    def step(params, cache, tokens, pos):
        logits, cache = step_fn(params, cache, tokens, pos)
        log.append(np.array(logits))
        return logits, cache
    return step


def test_hot_swap_leaves_the_cross_cache_as_computed():
    """A ``ServeDriver`` whose cross cache was precomputed from the first
    params: ``hot_swap`` installs the second params and leaves the cross
    cache as it was, in both packages, so the steps after the swap
    attend the old weights' K/V; tokens equal and logits within 1e-4 of
    the reference's throughout."""
    jcfg, cfg = _cfgs()
    trees = [_params(jcfg, 13), _params(jcfg, 14)]
    frames = _frames(cfg, 2, 15)
    jlog, log = [], []
    jdrv = JaxServeDriver(cfg=jcfg, params=jax.tree.map(jnp.asarray,
                                                        trees[0]),
                          batch=2, max_len=12, cache_dtype=jnp.float32,
                          step_fn=_recording(
                              jax_make_serve_step(jcfg, jit=False), jlog))
    drv = ServeDriver(cfg=cfg, params=load_lm_params(cfg, trees[0], "cpu"),
                      batch=2, max_len=12, cache_dtype=torch.float32,
                      step_fn=_recording(make_serve_step(cfg), log),
                      device="cpu")
    jdrv.cache = jax_precompute(jdrv.params, jcfg, jdrv.cache,
                                jnp.asarray(frames))
    precompute_cross_cache(drv.params, cfg, drv.cache,
                           torch.from_numpy(frames))
    cross = drv.cache["segments"][0]["pos1"]
    before = {k: v.clone() for k, v in cross.items()}
    prompt = np.array([[3], [7]], np.int32)
    want = [jdrv.generate(jnp.asarray(prompt), 3)]
    got = [drv.generate(torch.from_numpy(prompt), 3)]
    jdrv.hot_swap(jax.tree.map(jnp.asarray, trees[1]))
    drv.hot_swap(load_lm_params(cfg, trees[1], "cpu"))
    want.append(jdrv.generate(jnp.asarray(want[0][:, -1:]), 3))
    got.append(drv.generate(torch.from_numpy(got[0][:, -1:]), 3))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for k, v in cross.items():
        assert torch.equal(v, before[k])
        np.testing.assert_allclose(
            v.numpy(), np.asarray(jdrv.cache["segments"][0]["pos1"][k]),
            rtol=1e-5, atol=1e-5)
    for a, b in zip(log, jlog):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    assert len(log) == 6


def test_zero_frames_overflow_the_encoders_backward_in_both_packages():
    """The reference's training launcher feeds zero frames. At whisper's
    24 encoder layers (reduced width, one decoder layer) the encoder then
    runs on exact zeros: each pre-norm's RMSNorm scales its input's
    gradient by 1 / sqrt(eps) = 1000 and each attention sub-layer (the
    mean of V over the frames, linear in its input) passes it on, past
    the float range, so the encoder's parameter gradients are inf * 0 =
    NaN — in the reference's ``jax.grad`` as in the port's, on the same
    leaves. N(0, 1) frames train finite in both (the port's training
    launcher draws those from its seed)."""
    from repro.configs.base import Segment as JaxSegment
    from repro.training import init_train_state as jax_init_train_state
    from repro.training.trainer import loss_fn as jax_loss_fn
    from repro_torch.configs.base import Segment
    from repro_torch.convert import load_lm_train_state
    from repro_torch.core import tree
    from repro_torch.training import loss_and_grads
    jcfg, cfg = _cfgs()
    enc = jcfg.encoder_segments[0].pattern
    jcfg = dataclasses.replace(jcfg, encoder_segments=(JaxSegment(enc, 24),))
    cfg = dataclasses.replace(cfg, encoder_segments=(Segment(enc, 24),))
    st = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    port = load_lm_train_state(cfg, jax.tree.map(np.asarray, st),
                               device="cpu")
    tokens = np.random.default_rng(16).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    grad = jax.jit(jax.grad(lambda p, batch: jax_loss_fn(p, jcfg, batch)[0]))
    bad = {}
    for kind, frames in (("zeros", np.zeros((2, FRAMES, cfg.d_model),
                                            np.float32)),
                         ("normal", _frames(cfg, 2, 17))):
        jg = grad(st.params, {"tokens": jnp.asarray(tokens),
                              "enc_context": jnp.asarray(frames)})
        _, _, grads = loss_and_grads(port.params, cfg, {
            "tokens": torch.from_numpy(tokens),
            "enc_context": torch.from_numpy(frames)})
        bad[kind] = (
            sorted("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in path)
                   for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]
                   if not np.isfinite(np.asarray(g)).all()),
            sorted(path for path, g in tree.flatten_with_paths(grads)
                   if not torch.isfinite(g).all()))
    print(f"non-finite gradients with zero frames: {bad['zeros'][1]}")
    assert bad["zeros"][0] == bad["zeros"][1]
    assert bad["zeros"][1] and all(p.startswith("encoder/")
                                   for p in bad["zeros"][1])
    assert bad["normal"] == ([], [])
