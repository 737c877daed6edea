"""The port's LM training path against the JAX package's, on the CPU, at
``reduced(get_config("qwen2-1.5b"), layers_per_segment=2)`` (float32, 2
layers, tied head): ``lm_batches``, the SGD and Adam updates, the loss
and its gradients, three train steps, the chunked CE and the launcher.
The loss and gradients, remat and the three steps run for the MoE
config granite-moe-3b-a800m too (reduced the same way: 4 experts, top-2,
untied head; the loss includes the aux loss), at the same tolerances,
and its launcher run streams experts by (repeat, expert) id; and for the
attention-free mamba2-1.3b (reduced the same way: Mamba-2 mixers of 16
heads of 32, chunk 32, no FFN, tied head), whose float32 ``A_log``,
``D`` and ``dt_bias`` carry across under a bf16 ``param_dtype``; and for
gemma3-4b at a window of 8 (one 6-layer period of five windowed layers
and a global one), whose seq-32 batch takes the block-local branch
forward and backward; and for whisper-medium (one encoder layer and one
decoder layer of self-attention, cross attention and an MLP) on seeded
frames, the same on both sides (``_batch``), and its launcher on its
seeded N(0, 1) frames. (llama-3.2-vision-90b, dbrx-132b and
jamba-1.5-large-398b train with Adafactor: their step tests are in
``test_torch_hybrid.py``.)

The reference's ``init_train_state`` is perturbed leaf by leaf with
seeded numpy noise (so the zero-initialised norms and QKV biases take
part) and carried into the port with ``convert.load_lm_train_state``.
The port's wrappers run their plain versions on CPU tensors; the token
gather's gradient goes through the plain ``embedding_scatter_add``.

Tolerances, with the deviations measured when they were set (``pytest
-s`` prints them): the loss within rtol 1e-5 (measured 1.2e-07); grads
within rtol 1e-4, atol 1e-6 (largest |deviation| 8.3e-07, half the
tolerance at worst); pre-update losses of three steps within rtol 1e-4
(measured 2.4e-07). Params after three Adam steps within atol 3e-3
(measured 7.4e-04): Adam's update is ``lr * m / (sqrt(v) + eps)``, so
where a gradient is near 0 a deviation d of it moves the update by up
to ``lr * d / eps`` — and up to ``2 * lr`` a step where it flips the
sign — however small d is; almost every element agrees within 1e-5.
"""

import dataclasses
import sys
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import lm_batches as jax_lm_batches
from repro.optim import get_optimizer as jax_get_optimizer
from repro.training import init_train_state as jax_init_train_state
from repro.training import make_train_step as jax_make_train_step
from repro.training.trainer import _chunked_ce as jax_chunked_ce
from repro.training.trainer import loss_fn as jax_loss_fn
from repro_torch.convert import load_lm_train_state
from repro_torch.core import tree
from repro_torch.data import lm_batches
from repro_torch.kernels import ops as port_ops
from repro_torch.launch import train as port_train
from repro_torch.models import lm_head_weights
from repro_torch.optim import Adam, get_optimizer
from repro_torch.training import (TrainState, init_train_state,
                                  loss_and_grads, loss_fn, make_train_step)
from repro_torch.training.trainer import _chunked_ce

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import float64_math  # noqa: E402
from test_torch_lm import _cfgs as lm_cfgs  # noqa: E402

ARCH = "qwen2-1.5b"
MOE_ARCH = "granite-moe-3b-a800m"
SSM_ARCH = "mamba2-1.3b"
# gemma3-4b at a window of 8: the seq-32 batch takes the block-local
# branch forward and backward
WINDOW_ARCH = "gemma3-4b/w8"
# whisper-medium: an encoder layer and a decoder layer, its steps on
# seeded frames (``_batch``), the gradients flowing through the cross
# layer's K and V into the encoder
ENCDEC_ARCH = "whisper-medium"
STEP_ARCHS = [ARCH, MOE_ARCH, SSM_ARCH, WINDOW_ARCH, ENCDEC_ARCH]
# whisper's three Adam steps are held to a float64 run of the port as the
# windowed stack's are, but the share of elements beyond 1e-5 is no
# measure there: it counts Adam's sign flips at near-zero gradients (2 lr
# an element), a lottery in either float32 run. Over seeds 3-7 of
# ``_states`` the shares of params beyond 1e-5 from float64 read
# (reference / port): seed 3, the test's, 1.75e-4 / 7.31e-4; seed 4
# 2.07e-5 / 2.13e-5; seed 5 3.66e-4 / 1.95e-5; seed 6 7.56e-5 / 7.19e-5;
# seed 7 3.05e-5 / 1.77e-5 (slots: 7.83e-5 / 5.26e-4, 0 / 0, 3.57e-5 / 0,
# 1.38e-4 / 1.41e-4, 0 / 0): the port's share 0.05-4.2 times the
# reference's, while the largest param deviations stay within 1.65 times
# each other's. Both shares are held under 1e-3, the dense configs' bound
# for the port against the reference: 2.7 times the reference's largest
# share over those seeds (3.66e-4) and 1.37 times the largest of either
# (the port's at seed 3); the largest deviations within twice the
# reference's.
ENCDEC_SHARE = 1e-3
ADAM_ATOL = 3e-3
# The MoE stack's token-embedding gradient has a float32 rounding floor
# above the dense stack's atol of 1e-6: against a float64 run of the same
# step (``_float64_grads``), the reference's own float32 embed gradient
# lies 1.96 tolerances (rtol 1e-4, atol 1e-6) away and the port's 2.14,
# while the two differ by 1.29 (``test_loss_and_grads_match_reference``
# prints them under ``pytest -s``). Routing multiplies each expert's
# output by a gate computed from the layer's input, so rounding in one
# MoE layer moves the next one's gates. That leaf, and its Adam slots, is
# held with this atol for the MoE config; every other leaf with the
# dense stack's.
MOE_EMBED_ATOL = 3e-6
# The SSM stack's gradients have a float32 floor above the dense atol
# too: against a float64 run, the reference's own float32 gradients of
# embed, wB and wC lie 1.68, 1.33 and 1.10 dense tolerances away and the
# port's 2.00, 2.13 and 1.20, while the two differ by up to 2.41 (wB):
# these gradients of order 0.5 sum over every position of a chunk and the
# SSM state, so their float32 rounding reaches ~4e-6. Every leaf of an
# SSM config is held with this atol, and the port's worst leaf against
# float64 within twice the reference's (``test_loss_and_grads_match_
# reference`` prints both).
SSM_ATOL = 5e-6
# The windowed gemma3 stack (one 6-layer period, ``test_torch_lm``'s cut)
# is the deepest step config, and its float32 gradients have a floor
# above the dense atol too: against a float64 run, the reference's own
# float32 embed gradient lies 1.62e-05 away (5.92 dense tolerances) and
# the port's 1.81e-05 (6.34), while the two differ by 5.5e-06 (2.35).
# Every leaf of a windowed config is held with this atol, about the
# reference's own distance from float64, and the port's worst leaf
# against float64 within twice the reference's.
WINDOW_ATOL = 2e-5


def _cfgs(arch: str = ARCH):
    """Both packages' reduced configs, as ``test_torch_lm`` cuts them (a
    ``name/variant`` arch too)."""
    return lm_cfgs(arch)


def _states(seed: int = 0, arch: str = ARCH):
    """The reference's perturbed ``TrainState`` (JAX arrays) and the
    port's, carried across."""
    jcfg, cfg = _cfgs(arch)
    rng = np.random.default_rng(seed)
    st = jax_init_train_state(jcfg, jax.random.PRNGKey(seed))
    st = st._replace(params=jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.1 * rng.standard_normal(
            a.shape, dtype=np.float32)), st.params))
    port = load_lm_train_state(cfg, jax.tree.map(np.asarray, st),
                               device="cpu")
    return jcfg, cfg, st, port


def _tokens(cfg, n: int, seed: int = 1):
    batches = lm_batches(cfg.vocab_size, 4, 32, seed=seed)
    return [next(batches) for _ in range(n)]


def _batch(cfg, tokens: np.ndarray, jax_side: bool = False,
           dtype=torch.float32) -> dict:
    """A batch of ``tokens`` for the port (or, with ``jax_side``, the
    reference); a model with context gets N(0, 1) frames (B,
    encoder_len, D) seeded by the tokens' first id, the same on both
    sides."""
    frames = None
    if cfg.has_encoder_context:
        frames = np.random.default_rng(int(tokens[0, 0])).standard_normal(
            (tokens.shape[0], cfg.encoder_len, cfg.d_model),
            dtype=np.float32)
    if jax_side:
        batch = {"tokens": jnp.asarray(tokens)}
        if frames is not None:
            batch["enc_context"] = jnp.asarray(frames)
        return batch
    batch = {"tokens": torch.from_numpy(tokens)}
    if frames is not None:
        batch["enc_context"] = torch.from_numpy(frames).to(dtype)
    return batch


@pytest.mark.parametrize("structured", [True, False])
def test_lm_batches_equal_reference(structured):
    ours = lm_batches(1000, 3, 17, seed=5, structured=structured)
    want = jax_lm_batches(1000, 3, 17, seed=5, structured=structured)
    for _ in range(4):
        a, b = next(ours), next(want)
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["adam", "sgd"])
@pytest.mark.parametrize("step", [0, 1, 5, 99])
def test_optimizer_update_matches_reference(name, step):
    """One ``update`` on identical inputs (near-zero params included):
    params and Adam's slots within rtol 1e-6 (the slots' two products and
    a sum agree to the bit unless XLA contracts them into an FMA, which
    it may do for some elements and not others). The reference's step is
    an int32 array, as its train step passes it."""
    rng = np.random.default_rng(step)
    p = (0.05 * rng.standard_normal((64, 33))).astype(np.float32)
    p[0] = 1e-4
    g = rng.standard_normal((64, 33)).astype(np.float32)
    slots = {}
    if name == "adam":
        slots = {"m": (0.1 * rng.standard_normal((64, 33))).astype(
                     np.float32),
                 "v": (0.01 * rng.random((64, 33))).astype(np.float32)}
    wp, ws = jax_get_optimizer(name).update(
        jnp.asarray(p), {k: jnp.asarray(v) for k, v in slots.items()},
        jnp.asarray(g), jnp.asarray(step, jnp.int32))
    opt = get_optimizer(name)
    port_slots = {k: torch.from_numpy(v.copy()) for k, v in slots.items()}
    pp, ps = opt.update(torch.from_numpy(p), port_slots, torch.from_numpy(g),
                        step)
    np.testing.assert_allclose(pp.numpy(), np.asarray(wp), rtol=1e-6)
    for k in slots:
        np.testing.assert_allclose(ps[k].numpy(), np.asarray(ws[k]),
                                   rtol=1e-6)
        np.testing.assert_array_equal(port_slots[k].numpy(), slots[k])
    # the in-place tree update gives the same numbers
    params = {"a": [torch.from_numpy(p.copy())]}
    tslots = opt.init_slots_tree(params)
    for k in slots:
        tslots["a"][0][k].copy_(torch.from_numpy(slots[k]))
    out, out_slots = opt.update_tree(params, tslots,
                                     {"a": [torch.from_numpy(g)]}, step)
    assert out is params and out_slots is tslots
    assert torch.equal(params["a"][0], pp)


def test_adam_keeps_the_param_dtype():
    p = torch.randn(8, 4).bfloat16()
    new, slots = Adam().update(p, Adam().init_slots(p), torch.randn(8, 4), 0)
    assert new.dtype == torch.bfloat16
    assert slots["m"].dtype == slots["v"].dtype == torch.float32


def _leaf_atol(cfg, path: str) -> float:
    if cfg.window_size:
        return WINDOW_ATOL
    if cfg.ssm_state:
        return SSM_ATOL
    return MOE_EMBED_ATOL if cfg.num_experts and \
        path.split("/")[0] == "embed" else 1e-6


def _max_dev(jtree, ttree, cfg) -> tuple[float, float]:
    """(largest |deviation|, largest ratio of it to atol + rtol 1e-4 *
    |reference|) over the leaves, in flatten order; atol 1e-6, or
    ``MOE_EMBED_ATOL`` for a MoE config's embed gradient, ``SSM_ATOL``
    for an SSM config's leaves, ``WINDOW_ATOL`` for a windowed
    config's."""
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    port = tree.flatten_with_paths(ttree)
    assert len(flat) == len(port)
    worst = ratio = 0.0
    for (_, a), (path, b) in zip(flat, port):
        a, b = np.asarray(a), b.detach().numpy()
        d = np.abs(a - b)
        worst = max(worst, float(d.max()))
        ratio = max(ratio, float((d / (_leaf_atol(cfg, path)
                                       + 1e-4 * np.abs(a))).max()))
    return worst, ratio


def _float64_grads(cfg, params: dict, tokens: np.ndarray) -> dict:
    """The port's gradients of the same step computed in float64: every
    float32 cast of the path (``Tensor.float``) widened to float64 while
    it runs (``chip_smoke.float64_math``)."""
    with float64_math():
        return loss_and_grads(
            tree.map_like(lambda t: t.detach().double(), params),
            dataclasses.replace(cfg, dtype="float64",
                                param_dtype="float64"),
            _batch(cfg, tokens, dtype=torch.float64))[2]


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg, cfg, st, port = _states(0, arch)
    tokens = _tokens(cfg, 1)[0]
    (jl, jm), jg = jax.value_and_grad(jax_loss_fn, has_aux=True)(
        st.params, jcfg, _batch(cfg, tokens, jax_side=True))
    before = port_ops.launch_counts()
    loss, metrics, grads = loss_and_grads(port.params, cfg,
                                          _batch(cfg, tokens))
    assert port_ops.launch_counts() == before          # plain versions
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in ("loss", "ce", "ppl_log", "moe_aux"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, atol=1e-7)
    assert ("expert_counts" in metrics) == ("expert_counts" in jm)
    if cfg.num_experts:
        assert float(jm["moe_aux"]) > 0
        np.testing.assert_array_equal(metrics["expert_counts"].numpy(),
                                      np.asarray(jm["expert_counts"]))
        np.testing.assert_array_equal(
            metrics["expert_counts_per_layer"][0]["pos0"].numpy(),
            np.asarray(jm["expert_counts_per_layer"][0]["pos0"]))
    worst, ratio = _max_dev(jg, grads, cfg)
    print(f"loss rel dev {abs(float(loss) - float(jl)) / float(jl):.2g}; "
          f"grads max |dev| {worst:.2g}, {ratio:.2f} of the tolerance")
    assert ratio <= 1.0
    if cfg.num_experts or cfg.ssm_state or cfg.window_size:
        # the float32 floor: both float32 results against float64, over
        # the embed gradient for a MoE, over every leaf for an SSM or a
        # windowed stack
        exact = dict(tree.flatten_with_paths(
            _float64_grads(cfg, port.params, tokens)))
        ref = dict(zip(exact, (np.asarray(a) for _, a in
                               jax.tree_util.tree_flatten_with_path(jg)[0])))
        ours = {k: v.detach().numpy()
                for k, v in tree.flatten_with_paths(grads)}
        held = ["embed"] if cfg.num_experts else list(exact)

        def dense_tol(got):
            return max(float((np.abs(got[k] - exact[k].numpy())
                              / (1e-6 + 1e-4 * np.abs(exact[k].numpy())))
                             .max()) for k in held)

        floor = [dense_tol(ref), dense_tol(ours)]
        apart = max(float((np.abs(ours[k] - ref[k])
                           / (1e-6 + 1e-4 * np.abs(ref[k]))).max())
                    for k in held)
        print(f"{'/'.join(held) if cfg.num_experts else 'every'} grad in "
              f"dense tolerances: reference vs float64 {floor[0]:.2f}, "
              f"port vs float64 {floor[1]:.2f}, port vs reference "
              f"{apart:.2f}")
        assert floor[1] <= 2 * floor[0]
    # loss_fn alone gives the same loss
    l2, _ = loss_fn(port.params, cfg, _batch(cfg, tokens))
    assert float(l2.detach()) == float(loss)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_remat_gives_the_same_loss_and_grads(arch):
    """``cfg.remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``): same loss and grads as without, and for
    the MoE the same aux loss and expert counts out of the checkpointed
    blocks."""
    _, cfg, _, port = _states(2, arch)
    batch = _batch(cfg, _tokens(cfg, 1)[0])
    loss, m, grads = loss_and_grads(port.params, cfg, batch)
    loss_r, m_r, grads_r = loss_and_grads(
        port.params, dataclasses.replace(cfg, remat=True), batch)
    assert float(loss_r) == float(loss)
    assert float(m_r["moe_aux"]) == float(m["moe_aux"])
    if cfg.num_experts:
        assert torch.equal(m_r["expert_counts"], m["expert_counts"])
    for a, b in zip(tree.leaves(grads), tree.leaves(grads_r)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_three_train_steps_match_reference(arch):
    jcfg, cfg, st, port = _states(3, arch)
    assert isinstance(port, TrainState) and port.step == 0
    jstep = jax_make_train_step(jcfg, donate=False)
    step = make_train_step(cfg)
    losses = []
    for tokens in _tokens(cfg, 3, seed=4):
        st, jm = jstep(st, _batch(cfg, tokens, jax_side=True))
        params_before = port.params
        port, m = step(port, _batch(cfg, tokens))
        assert port.params is params_before             # updated in place
        losses.append((float(m["loss"]), float(jm["loss"])))
    assert port.step == 3 and int(st.step) == 3
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-4)
    flat = jax.tree_util.tree_flatten_with_path(st.params)[0]
    devs = np.concatenate([
        np.abs(np.asarray(a) - b.detach().numpy()).ravel()
        for (_, a), (_, b) in zip(flat, tree.flatten_with_paths(
            port.params))])
    print(f"losses {losses}; params max |dev| {devs.max():.2g}, "
          f"{(devs > 1e-5).mean():.2g} of elements beyond 1e-5")
    assert devs.max() <= ADAM_ATOL
    if cfg.window_size or cfg.is_encdec:
        _hold_steps_to_float64(arch, st, port,
                               ENCDEC_SHARE if cfg.is_encdec else None)
        return
    for (_, a), (path, b) in zip(
            jax.tree_util.tree_flatten_with_path(st.slots)[0],
            tree.flatten_with_paths(port.slots)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3,
                                   atol=_leaf_atol(cfg, path))
    assert (devs > 1e-5).mean() < 1e-3


def _hold_steps_to_float64(arch: str, st, port,
                           share_bound: Optional[float] = None) -> None:
    """The three steps of ``test_three_train_steps_match_reference`` for
    a windowed config, held to the float32 floor: the port's three steps
    rerun in float64 (``float64_math``) from the same state, and the
    port's float32 params and slots within twice the reference's own
    float32 distance from them, in largest |deviation| and in the share
    of elements beyond 1e-5. (After the first step, Adam's sign flips at
    near-zero gradients, up to 2 lr an element, move the next steps'
    gradients in either float32 run; in the six-layer windowed stack the
    reference's params sit 1.73e-3 from float64 and its slots 4.73e-5,
    while the two-layer stacks' slot bound is rtol 1e-3, atol 1e-6.)
    With ``share_bound``, the port's share beyond 1e-5 is held under it
    instead of under twice the reference's (``ENCDEC_SHARE``)."""
    _, cfg, _, exact = _states(3, arch)
    cfg64 = dataclasses.replace(cfg, dtype="float64", param_dtype="float64")
    with float64_math():
        exact = TrainState(
            params=tree.map_like(lambda t: t.detach().double(),
                                 exact.params),
            slots=tree.map_like(lambda t: t.double(), exact.slots), step=0)
        step = make_train_step(cfg64)
        for tokens in _tokens(cfg, 3, seed=4):
            exact, _ = step(exact, _batch(cfg, tokens,
                                          dtype=torch.float64))
    for name in ("params", "slots"):
        ref = np.concatenate([np.asarray(a, np.float64).ravel() for _, a in
                              jax.tree_util.tree_flatten_with_path(
                                  getattr(st, name))[0]])
        ours, want = (np.concatenate([v.detach().double().numpy().ravel()
                                      for v in tree.leaves(getattr(t,
                                                                   name))])
                      for t in (port, exact))
        d_ref, d_ours = np.abs(ref - want), np.abs(ours - want)
        print(f"{name} vs float64: reference max {d_ref.max():.3g}, "
              f"{(d_ref > 1e-5).mean():.3g} beyond 1e-5; port max "
              f"{d_ours.max():.3g}, {(d_ours > 1e-5).mean():.3g}; port vs "
              f"reference max {np.abs(ours - ref).max():.3g}")
        assert d_ours.max() <= 2 * d_ref.max()
        assert (d_ours > 1e-5).mean() <= (
            share_bound or 2 * (d_ref > 1e-5).mean())


def test_chunked_ce_equals_the_full_loss():
    """With ``loss_chunk`` set the CE runs chunk by chunk (ragged last
    chunk padded) and equals the full-logits loss; it also matches the
    reference's ``_chunked_ce`` on the same hidden states."""
    jcfg, cfg, st, port = _states(5)
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 1)[0])}
    full, _, full_g = loss_and_grads(port.params, cfg, batch)
    ccfg = dataclasses.replace(cfg, loss_chunk=7)        # 31 = 4 * 7 + 3
    chunked, _, chunked_g = loss_and_grads(port.params, ccfg, batch)
    np.testing.assert_allclose(float(chunked), float(full), rtol=1e-6)
    for a, b in zip(tree.leaves(full_g), tree.leaves(chunked_g)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    rng = np.random.default_rng(6)
    hidden = rng.standard_normal((3, 20, cfg.d_model), dtype=np.float32)
    targets = rng.integers(0, cfg.vocab_size, (3, 20)).astype(np.int32)
    head = np.asarray(st.params["embed"])
    want = jax_chunked_ce(jnp.asarray(hidden), jnp.asarray(head),
                          jnp.asarray(targets),
                          dataclasses.replace(jcfg, loss_chunk=8))
    got = _chunked_ce(torch.from_numpy(hidden), torch.from_numpy(head),
                      torch.from_numpy(targets),
                      dataclasses.replace(cfg, loss_chunk=8))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert lm_head_weights(port.params, cfg) is port.params["embed"]


def test_init_train_state_and_launcher_on_cpu(capsys):
    _, cfg = _cfgs()
    st = init_train_state(cfg, torch.Generator().manual_seed(0))
    assert st.step == 0
    loss_and_grads(st.params, cfg, {"tokens": torch.zeros((1, 4),
                                                          dtype=torch.int32)})
    assert all(p.requires_grad for p in tree.leaves(st.params))
    assert tree.flatten_with_paths(st.slots)[0][0] == "embed/m"
    state, engine, rec = port_train.main(
        ["--reduced", "--device", "cpu", "--steps", "6", "--batch", "2",
         "--seq", "16", "--log-every", "2"])
    out = capsys.readouterr().out
    assert out.count("step ") >= 3 and "serve staleness" in out
    assert state.step == 6 and len(rec["step_s"]) == 6
    assert rec["flushes"] and all(np.isfinite(rec["losses"]))
    assert rec["staleness"] < 2e-3                        # cast16
    with pytest.raises(RuntimeError, match="cuda"):
        if torch.cuda.is_available():
            raise RuntimeError("cuda is available here: nothing to check")
        port_train.main(["--reduced", "--steps", "1"])


def test_moe_launcher_on_cpu_streams_experts(capsys):
    """``launch.train --arch granite-moe-3b-a800m --reduced`` on the CPU:
    the reference's ``sync metrics`` keys printed, the expert leaves
    classified ``"experts"`` and streamed by (repeat, expert) id, the
    replica within the cast16 bound."""
    state, engine, rec = port_train.main(
        ["--arch", MOE_ARCH, "--reduced", "--layers", "2", "--device",
         "cpu", "--steps", "4", "--batch", "2", "--seq", "16",
         "--sync-period", "0", "--log-every", "2"])
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if x.startswith("sync metrics:"))
    for key in ("pushed_bytes", "queue_bytes", "dedup_ratio", "flushes",
                "skipped_dense"):
        assert f"'{key}'" in line
    experts = sorted(p for p, k in engine.kinds.items() if k == "experts")
    assert experts == [f"segments/0/pos0/ffn/{n}"
                       for n in ("w_down", "w_gate", "w_up")]
    recs = [r for p in range(engine.queue.num_partitions)
            for r in engine.queue.consume(p, 0)[0]
            if r.meta["kind"] == "experts"]
    assert recs and all(r.ids.max() < 2 * 4 for r in recs)
    assert rec["staleness"] < 2e-3 and len(rec["flushes"]) >= 2


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_load_lm_train_state_carries_moe_leaves(param_dtype):
    """``convert.load_lm_train_state`` on a MoE state: the float32 router
    (whatever ``param_dtype``), the (R, E, ...) expert leaves and their
    Adam slots carry across unchanged."""
    jcfg, cfg = (dataclasses.replace(c, param_dtype=param_dtype)
                 for c in _cfgs(MOE_ARCH))
    st = jax_init_train_state(jcfg, jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    st = st._replace(slots=jax.tree.map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32),
        st.slots))
    port = load_lm_train_state(cfg, jax.tree.map(np.asarray, st),
                               device="cpu")
    ffn, jffn = (s["segments"][0]["pos0"]["ffn"] for s in
                 (port.params, st.params))
    assert ffn["router"].dtype == torch.float32
    assert tuple(ffn["router"].shape) == (2, cfg.d_model, cfg.num_experts)
    for name in ("w_gate", "w_up", "w_down"):
        assert ffn[name].shape[:2] == (2, cfg.num_experts)
        assert ffn[name].dtype == (torch.float32 if param_dtype == "float32"
                                   else torch.bfloat16)
    for name, leaf in ffn.items():
        np.testing.assert_array_equal(
            leaf.float().numpy(), np.asarray(jffn[name]).astype(np.float32))
        for k in ("m", "v"):
            slot = port.slots["segments"][0]["pos0"]["ffn"][name][k]
            assert slot.dtype == torch.float32
            np.testing.assert_array_equal(
                slot.numpy(),
                st.slots["segments"][0]["pos0"]["ffn"][name][k])


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_load_lm_train_state_carries_mamba_leaves(param_dtype):
    """``convert.load_lm_train_state`` on a Mamba state: ``A_log``, ``D``
    and ``dt_bias`` in float32 whatever ``param_dtype``, the other leaves
    in it, every leaf and Adam slot equal to the reference's."""
    jcfg, cfg = (dataclasses.replace(c, param_dtype=param_dtype)
                 for c in _cfgs(SSM_ARCH))
    st = jax_init_train_state(jcfg, jax.random.PRNGKey(5))
    rng = np.random.default_rng(5)
    st = st._replace(slots=jax.tree.map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32),
        st.slots))
    port = load_lm_train_state(cfg, jax.tree.map(np.asarray, st),
                               device="cpu")
    mx, jmx = (s["segments"][0]["pos0"] for s in (port.params, st.params))
    assert sorted(mx) == sorted(jmx) == ["mixer"]            # no FFN
    mx, jmx = mx["mixer"], jmx["mixer"]
    pd = torch.float32 if param_dtype == "float32" else torch.bfloat16
    for name, leaf in mx.items():
        assert leaf.dtype == (torch.float32 if name in
                              ("A_log", "D", "dt_bias") else pd), name
        assert leaf.shape[0] == 2
        np.testing.assert_array_equal(
            leaf.float().numpy(), np.asarray(jmx[name]).astype(np.float32))
        for k in ("m", "v"):
            slot = port.slots["segments"][0]["pos0"]["mixer"][name][k]
            assert slot.dtype == torch.float32
            np.testing.assert_array_equal(
                slot.numpy(),
                st.slots["segments"][0]["pos0"]["mixer"][name][k])


def test_encdec_launcher_on_cpu_streams_the_encoder(capsys):
    """``launch.train --arch whisper-medium --reduced`` on the CPU: its
    steps run on frames (batch, encoder_len, d_model) drawn from the seed,
    N(0, 1), a new draw each step and the same in a second build (a
    forward without context raises; the reference launcher's zero frames
    overflow the encoder's backward at whisper's 24 layers), the
    encoder's leaves stream as dense leaves under the reference's paths,
    the replica within the cast16 bound."""
    from repro_torch.training import trainer
    seen, forward = [], trainer.forward

    def recording(params, cfg, tokens, enc_context=None, **kw):
        seen.append(enc_context)
        return forward(params, cfg, tokens, enc_context=enc_context, **kw)

    argv = ["--arch", ENCDEC_ARCH, "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "2", "--seq", "16",
            "--sync-period", "0", "--log-every", "1"]
    trainer.forward = recording
    try:
        state, engine, rec = port_train.main(argv)
    finally:
        trainer.forward = forward
    cfg = _cfgs(ENCDEC_ARCH)[1]
    batches = port_train.build(port_train.parse_args(argv))[-1]
    again = [next(batches)["enc_context"] for _ in range(3)]
    assert len(seen) == 3 and all(
        tuple(e.shape) == (2, cfg.encoder_len, cfg.d_model)
        and e.dtype == torch.float32 and torch.equal(e, a)
        for e, a in zip(seen, again))
    assert not torch.equal(seen[0], seen[1])
    frames = torch.stack(seen)
    assert abs(float(frames.mean())) < 0.05
    assert abs(float(frames.std()) - 1) < 0.05
    enc = [p for p in engine.paths if p.startswith("encoder/")]
    assert "encoder/segments/0/pos0/mixer/wq" in enc
    assert "encoder/final_norm" in enc
    assert {engine.kinds[p] for p in enc} == {"dense"}
    assert rec["staleness"] < 2e-3 and len(rec["flushes"]) >= 2
    assert all(np.isfinite(rec["losses"]))
    assert "serve staleness" in capsys.readouterr().out
