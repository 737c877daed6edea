"""The port's LM serving path against the JAX package's, on the CPU, at
``reduced(get_config(arch), layers_per_segment=2)`` for qwen2-1.5b (tied
head), qwen2-7b (untied ``lm_head``), the MoE configs
granite-moe-3b-a800m and dbrx-132b (4 experts, top-2; their aux loss and
``expert_counts_per_layer`` equal to the reference's) and the
attention-free mamba2-1.3b (Mamba-2 mixers, no FFN; its conv and SSM
states in the decode cache), and gemma3-4b (one period: five
sliding-window layers and a global one; the reduced window of 16, so S
= 24 takes the masked branch), its window cut to 8 (``gemma3-4b/w8``: S
= 24 takes the block-local branch, and the decode's rings of 8 rows
wrap) and a cut that keeps both of its segments (``gemma3-4b/segments``:
the 6-layer period once, then the local tail twice); and the two models
with context: whisper-medium (one encoder layer; a decoder layer of
self-attention, then cross attention and its MLP) and
llama-3.2-vision-90b (one 5-layer period, its cross layer first, the
frames reaching it without an encoder). Both packages get the same
seeded frames (``_frames``, (B, 16, D)); the decode caches' cross
entries are filled from them by each package's
``precompute_cross_cache``. A variant's ``dataclasses.replace`` is
applied alike to both packages' configs.

The reference's ``init_params`` tree is perturbed leaf by leaf with
seeded numpy noise (so the zero-initialised norms and QKV biases take
part) and carried into the port with ``convert.load_lm_params``; both
packages then run the same tokens. The port's wrappers run the plain
attention versions on CPU tensors. Float32 throughout: logits agree
within ``rtol=1e-4, atol=1e-4`` (sums in another order through two
layers and the vocab projection).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import precompute_cross_cache as jax_precompute
from repro.serving.predictor import ServeDriver as JaxServeDriver
from repro.serving.predictor import make_serve_step as jax_make_serve_step
from repro_torch.configs import get_config, reduced
from repro_torch.convert import load_lm_params
from repro_torch.kernels import ops as port_ops
from repro_torch.launch import serve as port_serve
from repro_torch.models import (decode_step, forward, init_cache, init_params,
                                precompute_cross_cache)
from repro_torch.serving.predictor import ServeDriver, make_serve_step

ARCHS = ["qwen2-1.5b", "qwen2-7b",
         "granite-moe-3b-a800m", "dbrx-132b", "mamba2-1.3b", "gemma3-4b",
         "gemma3-4b/w8", "gemma3-4b/segments", "whisper-medium",
         "llama-3.2-vision-90b"]
RTOL = ATOL = 1e-4


def variant(cfg, full, segment_cls, name: str):
    """``cfg`` (a reduced config of ``full``) cut as the variant ``name``
    says: ``w8`` a window of 8, ``segments`` both of ``full``'s segments,
    the first once and the second twice (``segment_cls`` is the package's
    ``Segment``)."""
    if name == "w8":
        return dataclasses.replace(cfg, window_size=8)
    if name == "segments":
        first, second = full.segments
        return dataclasses.replace(cfg, segments=(
            segment_cls(first.pattern, 1), segment_cls(second.pattern, 2)))
    raise ValueError(name)


def _cfgs(arch, layers_per_segment: int = 2):
    """The reduced config of ``arch`` (``name/variant`` for a variant) in
    both packages, the port's equal to the reference's: two layers, or
    one period where the segment's pattern is longer (gemma3's six)."""
    from repro.configs.base import Segment as JaxSegment
    from repro_torch.configs.base import Segment
    name, _, cut = arch.partition("/")
    jfull, full = jax_get_config(name), get_config(name)
    if len(full.segments[0].pattern) > 1:
        layers_per_segment = 1
    jcfg = jax_reduced(jfull, layers_per_segment=layers_per_segment)
    cfg = reduced(full, layers_per_segment=layers_per_segment)
    if cut:
        jcfg = variant(jcfg, jfull, JaxSegment, cut)
        cfg = variant(cfg, full, Segment, cut)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)  # a copy
    return jcfg, cfg


def _params(jcfg, seed: int):
    """The reference's parameters with every leaf perturbed, as numpy."""
    rng = np.random.default_rng(seed)
    tree = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
            a.shape, dtype=np.float32), tree)


def _frames(cfg, batch: int, seed: int):
    """Seeded N(0, 1) frames (batch, encoder_len, d_model) for a model
    with context, as numpy; None for one without."""
    if not cfg.has_encoder_context:
        return None
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.encoder_len, cfg.d_model), dtype=np.float32)


def _context(frames):
    """``frames`` for the reference and the port: (jax, torch), or Nones."""
    if frames is None:
        return None, None
    return jnp.asarray(frames), torch.from_numpy(frames)


def _close(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    return float(np.abs(got.numpy() - want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_load_lm_params_carries_every_leaf(arch):
    jcfg, cfg = _cfgs(arch)
    tree = _params(jcfg, 0)
    params = load_lm_params(cfg, tree, device="cpu")
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    for path, leaf in flat_j:
        node = params
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), leaf)
    # bfloat16 leaves (ml_dtypes in numpy) go through float32, exactly
    bf = jnp.asarray(tree["final_norm"]).astype(jnp.bfloat16)
    got = load_lm_params(cfg, {**tree, "final_norm": np.asarray(bf)},
                         device="cpu")["final_norm"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(bf.astype(jnp.float32)))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    jcfg, cfg = _cfgs(arch)
    tree = _params(jcfg, 1)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                               size=(2, 24)).astype(np.int32)
    jenc, enc = _context(_frames(cfg, 2, 12))
    want, jm = jax_forward(jax.tree.map(jnp.asarray, tree), jcfg,
                           jnp.asarray(tokens), enc_context=jenc)
    before = port_ops.launch_counts()
    got, metrics = forward(load_lm_params(cfg, tree, device="cpu"), cfg,
                           torch.from_numpy(tokens), enc_context=enc)
    assert port_ops.launch_counts() == before         # plain versions
    assert got.shape == (2, 24, cfg.padded_vocab)
    assert metrics["moe_aux"].dtype == torch.float32
    np.testing.assert_allclose(float(metrics["moe_aux"]),
                               float(jm["moe_aux"]), rtol=1e-5)
    assert ("expert_counts" in metrics) == bool(cfg.num_experts)
    if cfg.num_experts:
        np.testing.assert_array_equal(metrics["expert_counts"].numpy(),
                                      np.asarray(jm["expert_counts"]))
        (per_seg,), (jper_seg,) = (metrics["expert_counts_per_layer"],
                                   jm["expert_counts_per_layer"])
        assert sorted(per_seg) == sorted(jper_seg) == ["pos0"]
        assert per_seg["pos0"].dtype == torch.int32
        np.testing.assert_array_equal(per_seg["pos0"].numpy(),
                                      np.asarray(jper_seg["pos0"]))
    else:
        assert float(metrics["moe_aux"]) == 0.0
    _close(got, want)
    hidden, _ = forward(load_lm_params(cfg, tree, device="cpu"), cfg,
                        torch.from_numpy(tokens), enc_context=enc,
                        return_hidden=True)
    assert hidden.shape == (2, 24, cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_match_reference(arch):
    """Eight decode steps of the same tokens from an empty cache (twelve
    where a window is under the 12 rows, so its rings wrap; a model with
    context's cross entries filled first); the cache the port updates in
    place equals the reference's new cache at every position (K/V rows
    or ring, a Mamba layer's conv and SSM states, a cross layer's K/V,
    which carry the encoder's rounding and are held as a later layer's
    K/V are)."""
    jcfg, cfg = _cfgs(arch)
    tree = _params(jcfg, 3)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = load_lm_params(cfg, tree, device="cpu")
    b, max_len = 3, 12
    steps = max_len if 0 < cfg.window_size < max_len else 8
    jcache = jax_init_cache(jcfg, b, max_len, dtype=jnp.float32)
    cache = init_cache(cfg, b, max_len, dtype=torch.float32, device="cpu")
    jenc, enc = _context(_frames(cfg, b, 13))
    if enc is not None:
        jcache = jax_precompute(jparams, jcfg, jcache, jenc)
        precompute_cross_cache(params, cfg, cache, enc)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             size=(steps, b, 1)).astype(
                                                 np.int32)
    for t in range(steps):
        pos = np.full((b,), t, np.int32)
        want, jcache = jax_decode_step(jparams, jcfg, jcache,
                                       jnp.asarray(toks[t]), jnp.asarray(pos))
        got, cache2 = decode_step(params, cfg, cache, torch.from_numpy(toks[t]),
                                  torch.from_numpy(pos))
        assert cache2 is cache
        _close(got, want)
    first = 0                       # the stack's index of a segment's layer 0
    for seg, jseg, spec in zip(cache["segments"], jcache["segments"],
                               cfg.segments):
        assert sorted(seg) == sorted(jseg)
        for i, entry in seg.items():
            assert sorted(entry) == sorted(jseg[i])
            for k, v in entry.items():
                assert v.dtype == torch.float32
                assert v.shape == jseg[i][k].shape
                for r in range(spec.repeats):
                    layer = first + r * len(spec.pattern) + int(i[3:])
                    # the SSM state sums eight steps' products, and a K/V
                    # past the first two layers carries their rounding:
                    # the logits' 1e-4
                    tol = RTOL if k in ("state", "xk", "xv") or layer > 1 \
                        else 1e-5
                    np.testing.assert_allclose(
                        v[r].numpy(), np.asarray(jseg[i][k][r]), rtol=tol,
                        atol=tol)
        first += spec.repeats * len(spec.pattern)


def _recording(step_fn, log: list):
    def step(params, cache, tokens, pos):
        logits, cache = step_fn(params, cache, tokens, pos)
        log.append(np.array(logits))
        return logits, cache
    return step


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_driver_with_hot_swap_matches_reference(arch):
    """Two ``generate`` calls with a ``hot_swap`` between them: greedy
    tokens equal, every step's logits within tolerance (the largest
    deviation is printed; ``pytest -s`` shows it)."""
    jcfg, cfg = _cfgs(arch)
    trees = [_params(jcfg, 5), _params(jcfg, 6)]
    jlog, log = [], []
    jdrv = JaxServeDriver(cfg=jcfg, params=jax.tree.map(jnp.asarray,
                                                        trees[0]),
                          batch=2, max_len=16, cache_dtype=jnp.float32,
                          step_fn=_recording(jax_make_serve_step(jcfg, jit=False),
                                             jlog))
    drv = ServeDriver(cfg=cfg, params=load_lm_params(cfg, trees[0], "cpu"),
                      batch=2, max_len=16, cache_dtype=torch.float32,
                      step_fn=_recording(make_serve_step(cfg), log),
                      device="cpu")
    jenc, enc = _context(_frames(cfg, 2, 14))
    if enc is not None:             # from the first params, kept by the swap
        jdrv.cache = jax_precompute(jdrv.params, jcfg, jdrv.cache, jenc)
        precompute_cross_cache(drv.params, cfg, drv.cache, enc)
    prompt = np.array([[3], [7]], np.int32)
    want = [jdrv.generate(jnp.asarray(prompt), 4)]
    got = [drv.generate(torch.from_numpy(prompt), 4)]
    jdrv.hot_swap(jax.tree.map(jnp.asarray, trees[1]))
    drv.hot_swap(load_lm_params(cfg, trees[1], "cpu"))
    want.append(jdrv.generate(jnp.asarray(want[0][:, -1:]), 4))
    got.append(drv.generate(torch.from_numpy(got[0][:, -1:]), 4))
    for g, w in zip(got, want):
        assert g.shape == (2, 4)                   # a fresh accumulator
        np.testing.assert_array_equal(g, w)
    dev = max(_close(torch.from_numpy(a), b) for a, b in zip(log, jlog))
    assert len(log) == 8
    print(f"{arch}: max logit deviation over 8 steps {dev:.3g}")


def test_head_logits_mask_the_padded_vocab():
    """A vocabulary that is no multiple of 256 pads the table; the pad
    columns are -1e30 in both packages (the reduced configs' 512 pads
    nothing)."""
    from repro.models.model import head_logits as jax_head_logits
    from repro_torch.models import head_logits
    jcfg, cfg = (dataclasses.replace(c, vocab_size=500) for c in
                 _cfgs("qwen2-7b"))
    assert cfg.padded_vocab == 512
    rng = np.random.default_rng(8)
    head = rng.standard_normal((512, cfg.d_model), dtype=np.float32)
    x = rng.standard_normal((2, 3, cfg.d_model), dtype=np.float32)
    want = np.asarray(jax_head_logits(jnp.asarray(head), jcfg,
                                      jnp.asarray(x)))
    got = head_logits(torch.from_numpy(head), cfg, torch.from_numpy(x))
    assert (got[..., 500:] == -1e30).all() and (want[..., 500:] == -1e30).all()
    _close(got, want)


def test_serve_launcher_runs_reduced_on_cpu(capsys):
    tokens = port_serve.main(["--reduced", "--device", "cpu", "--steps", "9",
                              "--hot-swap-every", "4"])
    cfg = reduced(get_config("qwen2-1.5b"))
    assert tokens.shape == (4, 9) and tokens.dtype == np.int32
    assert ((0 <= tokens) & (tokens < cfg.vocab_size)).all()
    out = capsys.readouterr().out
    assert out.count("hot-swapped serve weights") == 2
    assert "generated shape=(4, 9)" in out


# the reference's ``test_decode_matches_forward`` configs that the port has
# (gemma3-4b at a window of 8: the forward takes the block-local branch,
# the decode's rings of 8 rows wrap twice), and the two models with
# context, their decode against a precomputed cross cache
CONSISTENCY_ARCHS = ["qwen2-1.5b", "mamba2-1.3b", "dbrx-132b",
                     "gemma3-4b/w8", "whisper-medium",
                     "llama-3.2-vision-90b"]


@pytest.mark.parametrize("arch", CONSISTENCY_ARCHS)
def test_decode_matches_forward(arch):
    """The port alone, as the reference's ``tests/test_models.py`` holds
    its own: 24 decode steps from an empty float32 cache against one
    forward over the same tokens, within the reference's 5e-4 (a MoE's
    capacity factor raised to 8 so neither path drops a token; a model
    with context's cross cache filled from the forward's frames)."""
    cfg = _cfgs(arch, layers_per_segment=1)[1]
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    params = init_params(cfg, torch.Generator().manual_seed(1))
    b, s = 2, 24
    tokens = torch.randint(0, cfg.vocab_size, (b, s),
                           generator=torch.Generator().manual_seed(2))
    enc = _context(_frames(cfg, b, 3))[1]
    full, _ = forward(params, cfg, tokens, enc_context=enc)
    cache = init_cache(cfg, b, s, dtype=torch.float32, device="cpu")
    if enc is not None:
        precompute_cross_cache(params, cfg, cache, enc)
    worst = 0.0
    for t in range(s):
        logits, cache = decode_step(params, cfg, cache, tokens[:, t:t + 1],
                                    torch.full((b,), t, dtype=torch.int32))
        worst = max(worst, float((logits - full[:, t])[
            :, :cfg.vocab_size].abs().max()))
    print(f"{arch}: decode/forward divergence {worst:.3g}")
    assert worst < 5e-4


def test_unported_configs_and_modes_raise():
    """Every architecture id resolves, the port's configs equal the
    reference's field by field (jamba-1.5-large-398b the last ported);
    an unknown id raises ``KeyError``. What still raises: explicit
    positions in ``forward`` (the flash kernel masks by index), a decode
    position past the cache and a length of 0."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro_torch.configs import ARCH_IDS, PORTED_ARCH_IDS
    assert ARCH_IDS == JAX_ARCH_IDS
    assert sorted(PORTED_ARCH_IDS) == sorted(ARCH_IDS)
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            jax_get_config(arch))
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config("jamba-2")
    cfg = reduced(get_config("qwen2-1.5b"))
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="positions"):
        forward(params, cfg, tokens, positions=torch.arange(4)[None])
    cache = init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(IndexError):                  # past the cache
        decode_step(params, cfg, cache, tokens[:, :1],
                    torch.tensor([8], dtype=torch.int32))
    with pytest.raises(ValueError, match="lengths must lie"):   # length 0
        decode_step(params, cfg, cache, tokens[:, :1],
                    torch.tensor([-1], dtype=torch.int32))
