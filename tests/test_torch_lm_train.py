"""The port's LM training path against the JAX package's, on the CPU, at
``reduced(get_config("qwen2-1.5b"), layers_per_segment=2)`` (float32, 2
layers, tied head): ``lm_batches``, the SGD and Adam updates, the loss
and its gradients, three train steps, the chunked CE and the launcher.

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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data import lm_batches as jax_lm_batches
from repro.optim import get_optimizer as jax_get_optimizer
from repro.training import init_train_state as jax_init_train_state
from repro.training import make_train_step as jax_make_train_step
from repro.training.trainer import _chunked_ce as jax_chunked_ce
from repro.training.trainer import loss_fn as jax_loss_fn
from repro_torch.configs import get_config, reduced
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

ARCH = "qwen2-1.5b"
ADAM_ATOL = 3e-3


def _cfgs():
    jcfg = jax_reduced(jax_get_config(ARCH), layers_per_segment=2)
    cfg = reduced(get_config(ARCH), layers_per_segment=2)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)   # a copy
    return jcfg, cfg


def _states(seed: int = 0):
    """The reference's perturbed ``TrainState`` (JAX arrays) and the
    port's, carried across."""
    jcfg, cfg = _cfgs()
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


def _max_dev(jtree, ttree) -> tuple[float, float]:
    """(largest |deviation|, largest ratio of it to atol 1e-6 + rtol
    1e-4 * |reference|) over the leaves, in flatten order."""
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    port = tree.flatten_with_paths(ttree)
    assert len(flat) == len(port)
    worst = ratio = 0.0
    for (_, a), (_, b) in zip(flat, port):
        a, b = np.asarray(a), b.detach().numpy()
        d = np.abs(a - b)
        worst = max(worst, float(d.max()))
        ratio = max(ratio, float((d / (1e-6 + 1e-4 * np.abs(a))).max()))
    return worst, ratio


def test_loss_and_grads_match_reference():
    jcfg, cfg, st, port = _states(0)
    tokens = _tokens(cfg, 1)[0]
    (jl, jm), jg = jax.value_and_grad(jax_loss_fn, has_aux=True)(
        st.params, jcfg, {"tokens": jnp.asarray(tokens)})
    before = port_ops.launch_counts()
    loss, metrics, grads = loss_and_grads(port.params, cfg,
                                          {"tokens": torch.from_numpy(tokens)})
    assert port_ops.launch_counts() == before          # plain versions
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in ("loss", "ce", "ppl_log", "moe_aux"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, atol=1e-7)
    worst, ratio = _max_dev(jg, grads)
    print(f"loss rel dev {abs(float(loss) - float(jl)) / float(jl):.2g}; "
          f"grads max |dev| {worst:.2g}, {ratio:.2f} of the tolerance")
    assert ratio <= 1.0
    # loss_fn alone gives the same loss
    l2, _ = loss_fn(port.params, cfg, {"tokens": torch.from_numpy(tokens)})
    assert float(l2.detach()) == float(loss)


def test_remat_gives_the_same_loss_and_grads():
    """``cfg.remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``): same loss and grads as without."""
    _, cfg, _, port = _states(2)
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 1)[0])}
    loss, _, grads = loss_and_grads(port.params, cfg, batch)
    loss_r, _, grads_r = loss_and_grads(
        port.params, dataclasses.replace(cfg, remat=True), batch)
    assert float(loss_r) == float(loss)
    for a, b in zip(tree.leaves(grads), tree.leaves(grads_r)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_three_train_steps_match_reference():
    jcfg, cfg, st, port = _states(3)
    assert isinstance(port, TrainState) and port.step == 0
    jstep = jax_make_train_step(jcfg, donate=False)
    step = make_train_step(cfg)
    losses = []
    for tokens in _tokens(cfg, 3, seed=4):
        st, jm = jstep(st, {"tokens": jnp.asarray(tokens)})
        params_before = port.params
        port, m = step(port, {"tokens": torch.from_numpy(tokens)})
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
    for (_, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(st.slots)[0],
            tree.flatten_with_paths(port.slots)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3,
                                   atol=1e-6)
    print(f"losses {losses}; params max |dev| {devs.max():.2g}, "
          f"{(devs > 1e-5).mean():.2g} of elements beyond 1e-5")
    assert devs.max() <= ADAM_ATOL
    assert (devs > 1e-5).mean() < 1e-3


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
