"""The hybrid family and Adafactor: the port against the JAX package, on
the CPU.

jamba-1.5-large-398b is ``reduced`` as ``test_torch_lm`` cuts a config
with a long pattern: one period of its eight positions (attention + MoE,
then Mamba + MLP and Mamba + MoE in turn), d_model 256, 4 experts,
top-2, SSM state 16 in heads of 32, chunk 32, float32. Its forward, its
decode and ``ServeDriver`` with a hot swap are held to the reference's
at rtol = atol = 1e-4 (measured: forward logits 1.2e-4 absolute on
logits of order 5, within the combined tolerance; decode 6.7e-5), the
decode's SSM states at ``SSM_STATE_ATOL``.

Adafactor trains jamba, dbrx-132b and llama-3.2-vision-90b (on seeded
frames): three steps through ``make_train_step`` from the reference's
perturbed ``TrainState`` carried by ``convert.load_lm_train_state``.
Pre-update losses within rtol 1e-4; params within atol
``ADAFACTOR_ATOL``; the factored slots ``vr`` / ``vc`` and the vectors'
``v`` within 1e-4 of each leaf's largest element, and jamba's, whose
SSM gradients have a float32 floor, within twice the reference's own
distance from a float64 run of the port. The deviations measured when
these were set are in ``test_three_adafactor_steps_match_reference``'s
docstring.

Adafactor's port updates a leaf of three or more dimensions in chunks of
its (a, b) slices over its leading axes, and a chunk or a matrix in one
float32 buffer (``optim/optimizers.py``); that update is held bit-equal
to the whole-leaf one (the arithmetic before the change) on the CPU, a
slice at a time, three at a time and whole. A zero
gradient moves nothing: after a step, an expert no token was routed to
and an embedding row no token touched are bit-unchanged in both
packages, which is what lets the sync engine's ``window`` mode stream
only the rows and experts touched in a period.
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
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.training import init_train_state as jax_init_train_state
from repro.training import make_train_step as jax_make_train_step
from repro_torch.configs import PORTED_ARCH_IDS, get_config
from repro_torch.configs.base import ATTN, MAMBA, MLP, MOE
from repro_torch.convert import load_lm_params, load_lm_train_state
from repro_torch.core import tree
from repro_torch.launch import train as port_train
from repro_torch.models import decode_step, forward, init_cache
from repro_torch.optim import get_optimizer, optimizers
from repro_torch.training import make_train_step

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_lm as lm  # noqa: E402
from chip_smoke import float64_math  # noqa: E402
import test_torch_lm_train as lm_train  # noqa: E402
from test_torch_cuda import _whole_leaf_adafactor  # noqa: E402

ARCH = "jamba-1.5-large-398b"
ADAFACTOR_ARCHS = [ARCH, "dbrx-132b", "llama-3.2-vision-90b"]
RTOL = ATOL = 1e-4
# The SSM states of jamba's seven Mamba layers sum eight steps of outer
# products of activations that have passed MoE layers: after eight
# decode steps both packages' float32 states lie up to 1.28e-3 (port)
# and 9.5e-4 (reference) from a float64 run of the port, on states of
# magnitude up to 176 (the port 1.27-1.60 times the reference's distance,
# entry by entry). Held with this atol (beside rtol 1e-4), about the
# port's own distance from float64, and within twice the reference's
# distance.
SSM_STATE_ATOL = 2e-3
# params after three Adafactor steps: jamba's lie 9.94e-5 from the
# reference's (measured; the dense stacks' 7.0e-6 and 1.35e-6), half of
# this and a fifteenth of the Adam tests' 3e-3
ADAFACTOR_ATOL = 2e-4


def test_config_equals_reference():
    """The port's jamba config is the reference's field by field, in full
    and reduced; every architecture of ``ARCH_IDS`` resolves."""
    jfull, full = jax_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert ARCH in PORTED_ARCH_IDS and full.optimizer == "adafactor"
    _, cfg = lm._cfgs(ARCH)            # asserts the reduced copies equal
    assert [(s.mixer, s.ffn) for s in cfg.segments[0].pattern] == [
        (ATTN, MOE), (MAMBA, MLP), (MAMBA, MOE), (MAMBA, MLP),
        (MAMBA, MOE), (MAMBA, MLP), (MAMBA, MOE), (MAMBA, MLP)]
    assert (cfg.num_experts, cfg.experts_per_token, cfg.ssm_chunk) == \
        (4, 2, 32)


def test_forward_matches_reference():
    """A forward over 2 x 40 tokens (past one SSD chunk): logits, the aux
    loss and every MoE position's expert counts as the reference's."""
    jcfg, cfg = lm._cfgs(ARCH)
    params = lm._params(jcfg, 1)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want, jm = jax_forward(jax.tree.map(jnp.asarray, params), jcfg,
                           jnp.asarray(tokens))
    got, m = forward(load_lm_params(cfg, params, device="cpu"), cfg,
                     torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(m["moe_aux"]), float(jm["moe_aux"]),
                               rtol=1e-5)
    (per,), (jper,) = m["expert_counts_per_layer"], \
        jm["expert_counts_per_layer"]
    assert sorted(per) == sorted(jper) == ["pos0", "pos2", "pos4", "pos6"]
    for pos in per:
        np.testing.assert_array_equal(per[pos].numpy(), np.asarray(jper[pos]))
    np.testing.assert_array_equal(m["expert_counts"].numpy(),
                                  np.asarray(jm["expert_counts"]))


def test_decode_steps_match_reference():
    """Eight decode steps from an empty float32 cache, as
    ``test_torch_lm`` runs them: logits, the attention layer's K/V and
    the Mamba layers' conv states within 1e-4 of the reference's; the SSM
    states within ``SSM_STATE_ATOL``, and no farther from a float64 run
    of the port than twice the reference's own distance from it."""
    jcfg, cfg = lm._cfgs(ARCH)
    tree_np = lm._params(jcfg, 3)
    jparams = jax.tree.map(jnp.asarray, tree_np)
    params = load_lm_params(cfg, tree_np, device="cpu")
    b, max_len, steps = 3, 12, 8
    jcache = jax_init_cache(jcfg, b, max_len, dtype=jnp.float32)
    cache = init_cache(cfg, b, max_len, dtype=torch.float32, device="cpu")
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (steps, b, 1)).astype(np.int32)
    for t in range(steps):
        pos = np.full((b,), t, np.int32)
        want, jcache = jax_decode_step(jparams, jcfg, jcache,
                                       jnp.asarray(toks[t]), jnp.asarray(pos))
        got, cache = decode_step(params, cfg, cache,
                                 torch.from_numpy(toks[t]),
                                 torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    cfg64 = dataclasses.replace(cfg, dtype="float64", param_dtype="float64")
    with float64_math():
        p64 = tree.map_like(lambda x: x.double(), params)
        c64 = tree.map_like(lambda x: x.double(), init_cache(
            cfg64, b, max_len, dtype=torch.float64, device="cpu"))
        for t in range(steps):
            _, c64 = decode_step(p64, cfg64, c64, torch.from_numpy(toks[t]),
                                 torch.from_numpy(np.full((b,), t,
                                                          np.int32)))
    (seg,), (jseg,), (seg64,) = (cache["segments"], jcache["segments"],
                                 c64["segments"])
    assert sorted(seg) == sorted(jseg)
    ratio = 0.0
    for pos, entry in seg.items():
        assert sorted(entry) == sorted(jseg[pos])
        for k, v in entry.items():
            a, want = v.numpy(), np.asarray(jseg[pos][k])
            assert v.dtype == torch.float32 and a.shape == want.shape
            atol = SSM_STATE_ATOL if k == "state" else ATOL
            np.testing.assert_allclose(a, want, rtol=RTOL, atol=atol)
            exact = seg64[pos][k].numpy()
            ratio = max(ratio, float(np.abs(a - exact).max()
                                     / np.abs(want - exact).max()))
    print(f"jamba decode: cache entries at most {ratio:.2f} times the "
          f"reference's distance from float64")
    assert ratio <= 2.0


def test_serve_driver_with_hot_swap_matches_reference():
    lm.test_serve_driver_with_hot_swap_matches_reference(ARCH)


@pytest.mark.parametrize("chunk", [64 * 96, 3 * 64 * 96, 1 << 28])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 64, 96), (2, 4, 64, 96), (64, 96),
                                   (96,)])
def test_sliced_update_bit_equal_to_whole_leaf(shape, dtype, chunk,
                                               monkeypatch):
    """Four steps (one with zero rows in the gradient), the leaf updated a
    slice at a time, three slices at a time and whole
    (``ADAFACTOR_CHUNK_ELEMS``): params and slots bit-equal to the
    whole-leaf update's."""
    monkeypatch.setattr(optimizers, "ADAFACTOR_CHUNK_ELEMS", chunk)
    opt = get_optimizer("adafactor")
    rng = np.random.default_rng(0)
    p0 = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    a, b = p0.to(dtype), p0.to(dtype)
    sa, sb = opt.init_slots(a), opt.init_slots(b)
    for step in range(4):
        g = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        if step == 2 and len(shape) > 1:
            g[..., 3, :] = 0
        _whole_leaf_adafactor(opt, a, sa, g.to(dtype), step)
        opt.update_(b, sb, g.to(dtype), step)
    assert torch.equal(a, b) and b.dtype == dtype
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k])


@pytest.mark.parametrize("arch", ADAFACTOR_ARCHS)
def test_three_adafactor_steps_match_reference(arch):
    """Three Adafactor steps from the reference's perturbed state
    (``test_torch_lm_train._states``), the same batches on both sides (a
    model with context on seeded frames): losses within rtol 1e-4, params
    within ``ADAFACTOR_ATOL``; slots within 1e-4 of each leaf's largest
    element for the dense stacks, and for jamba as its params are held
    in ``test_torch_lm_train``'s windowed and encoder-decoder stacks:
    within twice the reference's own distance from a float64 run of the
    port.

    Measured when the bounds were set (``pytest -s`` prints them), the
    port against the reference, the reference and the port against
    float64: losses within 1.05e-5 relative (jamba's third step; the
    dense stacks' 1.2e-7); params 9.94e-5 (jamba: its
    SSM gradients' float32 floor, ``SSM_ATOL`` in
    ``test_torch_lm_train``; float64 4.91e-5 / 7.83e-5), 7.0e-6
    (llama-vision; 1.01e-5 / 4.46e-6), 1.35e-6 (dbrx; 8.05e-7 /
    1.42e-6); slots, of each leaf's largest, 5.6e-3 (jamba; 9.1e-3 /
    5.8e-3), 2.2e-5 (llama-vision; 2.0e-5 / 2.4e-5), 1.2e-5 (dbrx;
    1.4e-5 / 9.9e-6). Elementwise, a slot of order g^2 where g is near
    0 is no measure: the reference's own llama-vision slots lie 4.5e-4
    from float64 relative to the element. Adafactor divides each update
    by a row and a column mean of g^2 rather than by the element's own,
    so a near-zero gradient's rounding moves its update by ~lr * |dg| /
    rms(g), not Adam's lr * |dg| / eps."""
    jcfg, cfg, st, port = lm_train._states(3, arch)
    assert cfg.optimizer == "adafactor" and port.step == 0
    jstep = jax_make_train_step(jcfg, donate=False)
    step = make_train_step(cfg)
    losses = []
    for tokens in lm_train._tokens(cfg, 3, seed=4):
        st, jm = jstep(st, lm_train._batch(cfg, tokens, jax_side=True))
        port, m = step(port, lm_train._batch(cfg, tokens))
        losses.append((float(m["loss"]), float(jm["loss"])))
    assert port.step == 3
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-4)
    pdev = max(float(np.abs(np.asarray(a) - b.detach().numpy()).max())
               for (_, a), b in zip(
                   jax.tree_util.tree_flatten_with_path(st.params)[0],
                   tree.leaves(port.params)))
    jslots = jax.tree_util.tree_flatten_with_path(st.slots)[0]
    pslots = tree.flatten_with_paths(port.slots)
    assert len(jslots) == len(pslots)
    srel = 0.0
    for (jpath, a), (path, b) in zip(jslots, pslots):
        assert path.rsplit("/", 1)[-1] == jpath[-1].key
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        srel = max(srel, float(np.abs(a - b).max() / np.abs(a).max()))
    print(f"{arch}: losses {losses}; params max |dev| {pdev:.3g}; slots "
          f"max dev {srel:.3g} of the leaf's largest")
    assert pdev <= ADAFACTOR_ATOL
    if cfg.ssm_state:
        lm_train._hold_steps_to_float64(arch, st, port)
    else:
        assert srel <= 1e-4


def test_load_lm_train_state_carries_factored_slots():
    """``vr`` / ``vc`` of every matrix and stacked leaf and ``v`` of every
    vector, bit for bit; a slot of another shape or name raises."""
    jcfg, cfg = lm._cfgs(ARCH)
    st = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    slots = jax.tree.map(lambda a: np.abs(rng.standard_normal(
        a.shape)).astype(np.float32), st.slots)
    st = jax.tree.map(np.asarray, st._replace(slots=slots))
    port = load_lm_train_state(cfg, st, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(st.slots)[0]
    names = set()
    for (_, a), b in zip(flat, tree.leaves(port.slots)):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), a)
    for path, s in tree.flatten_with_paths(port.slots):
        names.add(path.rsplit("/", 1)[-1])
    assert names == {"vr", "vc", "v"}
    w_up = port.slots["segments"][0]["pos0"]["ffn"]["w_up"]
    assert w_up["vr"].shape == (1, 4, cfg.d_model)
    assert w_up["vc"].shape == (1, 4, cfg.d_ff)
    assert set(port.slots["final_norm"]) == {"v"}
    bad = jax.tree.map(lambda a: a, st.slots)
    vr = bad["embed"]["vr"]
    bad["embed"] = {"vr": vr[:-1], "vc": bad["embed"]["vc"]}
    with pytest.raises(ValueError, match="slots"):
        load_lm_train_state(cfg, st._replace(slots=bad), device="cpu")
    adam = jax.tree.map(lambda a: a, st.slots)
    emb = st.params["embed"]
    adam["embed"] = {"m": np.zeros_like(emb), "v": np.zeros_like(emb)}
    with pytest.raises(ValueError, match="adafactor"):
        load_lm_train_state(cfg, st._replace(slots=adam), device="cpu")


def test_zero_gradient_moves_nothing():
    """One Adafactor step on a batch of 3 tokens: in both packages, the
    (repeat, expert) slices of every MoE position that no token was
    routed to, and every embedding row no token touched, are bit-equal
    to what they were before the step."""
    jcfg, cfg, st, port = lm_train._states(5, ARCH)
    before = tree.map_like(lambda t: t.detach().clone(), port.params)
    jbefore = jax.tree.map(np.asarray, st.params)
    tokens = np.array([[5, 77, 5]], np.int32)
    st, jm = jax_make_train_step(jcfg, donate=False)(
        st, {"tokens": jnp.asarray(tokens)})
    port, m = make_train_step(cfg)(port, {"tokens": torch.from_numpy(tokens)})
    per = m["expert_counts_per_layer"][0]
    unrouted = {pos: np.nonzero(c.numpy() == 0) for pos, c in per.items()}
    assert sum(len(r) for r, _ in unrouted.values()) > 0
    untouched = np.setdiff1d(np.arange(cfg.padded_vocab), tokens)
    for side, new, old in (("port", port.params, before),
                           ("reference", jax.tree.map(np.asarray, st.params),
                            jbefore)):
        as_np = (lambda t: t.detach().numpy()) if side == "port" \
            else np.asarray
        np.testing.assert_array_equal(as_np(new["embed"])[untouched],
                                      as_np(old["embed"])[untouched])
        assert not np.array_equal(as_np(new["embed"])[tokens[0]],
                                  as_np(old["embed"])[tokens[0]])
        for pos, (reps, experts) in unrouted.items():
            for name in ("w_gate", "w_up", "w_down"):
                a = as_np(new["segments"][0][pos]["ffn"][name])
                b = as_np(old["segments"][0][pos]["ffn"][name])
                np.testing.assert_array_equal(a[reps, experts],
                                              b[reps, experts])


def test_launcher_trains_jamba_with_adafactor(capsys):
    """``launch.train --arch jamba-1.5-large-398b --reduced --device cpu``:
    Adafactor's factored slots, finite losses, the experts streamed by
    (repeat, expert) id in window mode, the replica within the cast16
    bound."""
    state, engine, rec = port_train.main(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "3",
         "--batch", "2", "--seq", "16", "--sync-period", "0",
         "--log-every", "1"])
    out = capsys.readouterr().out
    assert "arch=jamba-1.5-large-398b-smoke layers=8" in out
    assert state.step == 3 and all(np.isfinite(rec["losses"]))
    names = {p.rsplit("/", 1)[-1] for p, _ in
             tree.flatten_with_paths(state.slots)}
    assert names == {"vr", "vc", "v"}
    assert engine._embed_mode == "window"
    experts = sorted(p for p, k in engine.kinds.items() if k == "experts")
    assert len(experts) == 3 * 4
    assert rec["staleness"] < 2e-3 and len(rec["flushes"]) >= 2
