"""The port's Mamba-2 / SSD module (``models/ssm.py``) against the JAX
package's, function by function, on the CPU in float32 from numpy inputs
made from a seed, and the two faults of the reference that the port does
not copy.

Tolerances: rtol = atol = 1e-4 for values (sums in another order: the
port contracts the reference's three-operand einsums pairwise); the
gradients within 1e-4 of each leaf's largest magnitude. ``pytest -s``
prints the deviations.

The faults:
- At a chunk of 256 with dt ≈ 1 the reference's SSD gradient is NaN: it
  takes ``exp`` over the whole (l, l) square before masking, the upper
  triangle overflows, and the backward multiplies the zero cotangent by
  inf. The port masks before the exponential: its gradient is finite
  and equals autograd through a float64 step-by-step recurrence.
- bfloat16 params with a float32 cache: the reference's mamba decode
  returns the promoted float32 and its ``decode_step`` scan raises
  ``TypeError``; the port casts the mixer's output back to the
  activations' dtype.
"""

import dataclasses
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_config, reduced
from repro_torch.convert import load_lm_params
from repro_torch.models import decode_step, init_cache, ssm

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import BF16_LOGIT_BOUND, ssd_recurrence_check  # noqa: E402

ARCH = "mamba2-1.3b"
RTOL = ATOL = 1e-4
GRAD_BOUND = 1e-4           # of the leaf's largest |gradient|
REC_BOUND = 2e-4            # chunk 256 vs the float64 recurrence
# bfloat16 decode, port vs reference, both with a bfloat16 cache: the two
# round the same values at different points (torch's SiLU rounds once
# where XLA rounds x * sigmoid(x) per op, and the products sum in another
# order), so each step's logits differ by a few bf16 roundings of values
# of order one. The bound is 1/16 of the largest |logit|: 16 ulps of
# bf16's 2^-8 relative step.
BF16_REL_BOUND = 1 / 16


def _cfgs(**kw):
    jcfg = jax_reduced(jax_get_config(ARCH), layers_per_segment=2)
    cfg = reduced(get_config(ARCH), layers_per_segment=2)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)   # a copy
    return (dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw))


def _tree(jcfg, seed: int):
    """The reference's parameters with every leaf perturbed, as numpy."""
    rng = np.random.default_rng(seed)
    tree = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
        a.shape, dtype=np.float32), tree)


def _layer0(cfg, tree):
    """Layer 0's mixer params: the reference's (numpy) and the port's,
    carried across with ``load_lm_params``."""
    port = load_lm_params(cfg, tree, device="cpu")
    jp = {k: v[0] for k, v in tree["segments"][0]["pos0"]["mixer"].items()}
    tp = {k: v[0] for k, v in port["segments"][0]["pos0"]["mixer"].items()}
    return jp, tp


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    return float(np.abs(got - want).max())


def _ssd_inputs(rng, b, s, h, p, n, dt_scale=1.0):
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(dt_scale * rng.standard_normal(
        (b, s, h)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, n), dtype=np.float32)
    C = rng.standard_normal((b, s, n), dtype=np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 12), dtype=np.float32)
    w = rng.standard_normal((4, 12), dtype=np.float32)
    b = rng.standard_normal(12, dtype=np.float32)
    st = rng.standard_normal((2, 3, 12), dtype=np.float32) \
        if with_state else None
    want, want_st = jax_ssm._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st))
    got, got_st = ssm._causal_conv(_t(x), _t(w), _t(b),
                                   None if st is None else _t(st))
    _close(got, want)
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_chunked_matches_reference(chunk):
    """S = 45 is no multiple of either chunk (the padding); then the
    sequence in two calls, the state threaded from the first to the
    second, against the reference's two calls and the port's one."""
    rng = np.random.default_rng(chunk)
    x, dt, A, B, C = _ssd_inputs(rng, 2, 45, 3, 4, 8)
    want, want_st = jax_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)),
                                        chunk)
    got, got_st = ssm.ssd_chunked(*map(_t, (x, dt, A, B, C)), chunk)
    assert got.dtype == torch.float32 and got_st.dtype == torch.float32
    dev = max(_close(got, want), _close(got_st, want_st))
    cut = 19
    j1, jst = jax_ssm.ssd_chunked(*(jnp.asarray(a[:, :cut]) if a.ndim > 1
                                    else jnp.asarray(a)
                                    for a in (x, dt, A, B, C)), chunk)
    j2, jfin = jax_ssm.ssd_chunked(*(jnp.asarray(a[:, cut:]) if a.ndim > 1
                                     else jnp.asarray(a)
                                     for a in (x, dt, A, B, C)), chunk,
                                   initial_state=jst)
    p1, pst = ssm.ssd_chunked(*(_t(a[:, :cut]) if a.ndim > 1 else _t(a)
                                for a in (x, dt, A, B, C)), chunk)
    p2, pfin = ssm.ssd_chunked(*(_t(a[:, cut:]) if a.ndim > 1 else _t(a)
                                 for a in (x, dt, A, B, C)), chunk,
                               initial_state=pst)
    dev = max(dev, _close(torch.cat([p1, p2], 1),
                          np.concatenate([j1, j2], 1)),
              _close(pfin, jfin), _close(pfin, got_st))
    _close(torch.cat([p1, p2], 1), got)
    print(f"chunk {chunk}: max deviation {dev:.3g}")


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(3)
    x, dt, A, B, C = _ssd_inputs(rng, 2, 1, 3, 4, 8)
    st = rng.standard_normal((2, 3, 4, 8), dtype=np.float32)
    want, want_st = jax_ssm.ssd_decode_step(
        jnp.asarray(st), jnp.asarray(x[:, 0]), jnp.asarray(dt[:, 0]),
        jnp.asarray(A), jnp.asarray(B[:, 0]), jnp.asarray(C[:, 0]))
    got, got_st = ssm.ssd_decode_step(_t(st), _t(x[:, 0]), _t(dt[:, 0]),
                                      _t(A), _t(B[:, 0]), _t(C[:, 0]))
    _close(got, want)
    _close(got_st, want_st)


def test_mamba_block_matches_reference():
    """The mixer at the reduced config's chunk (32) over 45 tokens, its
    output and final state."""
    jcfg, cfg = _cfgs()
    jp, tp = _layer0(cfg, _tree(jcfg, 4))
    x = np.random.default_rng(5).standard_normal(
        (2, 45, cfg.d_model), dtype=np.float32)
    want, want_st = jax_ssm.mamba_block(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jcfg,
        return_state=True)
    got, got_st = ssm.mamba_block(tp, _t(x), cfg, return_state=True)
    print(f"mamba_block: max deviation {_close(got, want):.3g}, state "
          f"{_close(got_st, want_st):.3g}")
    assert torch.equal(ssm.mamba_block(tp, _t(x), cfg), got)


def test_mamba_decode_step_matches_reference():
    """Six steps from a zero cache: outputs, conv and SSM states."""
    jcfg, cfg = _cfgs()
    jp, tp = _layer0(cfg, _tree(jcfg, 6))
    jp = jax.tree.map(jnp.asarray, jp)
    rng = np.random.default_rng(7)
    ch = cfg.d_inner + 2 * cfg.ssm_state
    jconv = jnp.zeros((2, cfg.ssm_conv_width - 1, ch))
    jstate = jnp.zeros((2, cfg.ssm_num_heads, cfg.ssm_head_dim,
                        cfg.ssm_state))
    conv, state = torch.zeros(jconv.shape), torch.zeros(jstate.shape)
    for _ in range(6):
        x = rng.standard_normal((2, 1, cfg.d_model), dtype=np.float32)
        want, jconv, jstate = jax_ssm.mamba_decode_step(
            jp, jnp.asarray(x), jconv, jstate, jcfg)
        got, conv, state = ssm.mamba_decode_step(tp, _t(x), conv, state,
                                                 cfg)
        _close(got, want)
        _close(conv, jconv)
        _close(state, jstate)


def _max_rel(got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_mamba_block_grads_match_jax():
    """Gradients of ``sum(w * mamba_block(p, x))`` with respect to every
    parameter and x, at chunk 32 over 45 tokens, against ``jax.grad``."""
    jcfg, cfg = _cfgs()
    jp, tp = _layer0(cfg, _tree(jcfg, 8))
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 45, cfg.d_model), dtype=np.float32)
    w = rng.standard_normal((2, 45, cfg.d_model), dtype=np.float32)

    def jloss(p, x):
        return jnp.sum(jnp.asarray(w) * jax_ssm.mamba_block(p, x, jcfg))

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = _t(x).requires_grad_(True)
    (_t(w) * ssm.mamba_block(tp, tx, cfg)).sum().backward()
    # the pre-mixer norm is the model's, not the block's: no gradient
    assert tp["norm"].grad is None and not np.asarray(jg["norm"]).any()
    devs = {k: _max_rel(tp[k].grad.numpy(), jg[k]) for k in jp
            if k != "norm"}
    devs["x"] = _max_rel(tx.grad.numpy(), jgx)
    print("grad deviations / largest |grad|: "
          + ", ".join(f"{k} {v:.2g}" for k, v in devs.items()))
    assert max(devs.values()) <= GRAD_BOUND


def _recurrence64(x, dt, A, B, C):
    """The SSD as a float64 step-by-step recurrence (autograd runs through
    it): h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t, y_t = C_t · h_t."""
    b, s, h, p = x.shape
    state = x.new_zeros((b, h, p, B.shape[-1]))
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * A)
        upd = (x[:, t] * dt[:, t, :, None])[..., None] \
            * B[:, t, None, None, :]
        state = state * decay[:, :, None, None] + upd
        ys.append((state * C[:, t, None, None, :]).sum(-1))
    return torch.stack(ys, 1), state


def test_chunk_256_gradient_is_finite_where_the_reference_is_nan():
    """1 x 512 steps, 2 heads, dt ≈ 1 (``dt_bias``'s init, log(e - 1),
    plus small noise, through softplus) and A = -1, chunk 256 (mamba2's
    own): the reference's gradient with respect to dt holds NaN; the
    port's forward equals the reference's and its gradients with respect
    to x, dt, B and C are finite and within ``REC_BOUND`` of the
    float64 recurrence's largest magnitude."""
    rng = np.random.default_rng(10)
    b, s, h, p, n = 1, 512, 2, 4, 8
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(math.log(math.e - 1) + 0.1 * rng.standard_normal(
        (b, s, h)))).astype(np.float32)
    A = -np.ones(h, np.float32)
    B = rng.standard_normal((b, s, n), dtype=np.float32)
    C = rng.standard_normal((b, s, n), dtype=np.float32)
    wy = rng.standard_normal((b, s, h, p), dtype=np.float32)
    wf = rng.standard_normal((b, h, p, n), dtype=np.float32)

    def jloss(x, dt, B, C):
        y, fin = jax_ssm.ssd_chunked(x, dt, jnp.asarray(A), B, C, 256)
        return jnp.sum(y * wy) + jnp.sum(fin * wf)

    jy, _ = jax_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), 256)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, dt, B, C)))
    assert np.isfinite(np.asarray(jy)).all()
    assert np.isnan(np.asarray(jgrads[1])).any()          # grad dt

    def grads(fn, dtype):
        ins = [_t(a).to(dtype).requires_grad_(True) for a in (x, dt, B, C)]
        y, fin = fn(ins[0], ins[1], _t(A).to(dtype), ins[2], ins[3])
        ((y * _t(wy).to(dtype)).sum() + (fin * _t(wf).to(dtype)).sum()
         ).backward()
        return y, [t.grad for t in ins]

    y, got = grads(lambda *a: ssm.ssd_chunked(*a, 256), torch.float32)
    _close(y, jy)
    _, want = grads(_recurrence64, torch.float64)
    devs = {}
    for name, g, w in zip(("x", "dt", "B", "C"), got, want):
        assert torch.isfinite(g).all(), name
        devs[name] = _max_rel(g.numpy(), w.numpy())
    print(f"chunk 256 vs the float64 recurrence: reference grad dt NaNs "
          f"{int(np.isnan(np.asarray(jgrads[1])).sum())}; port grad "
          f"deviations / largest " + ", ".join(
              f"{k} {v:.2g}" for k, v in devs.items()))
    assert max(devs.values()) <= REC_BOUND


def test_smoke_ssd_check_runs_on_cpu():
    """``chip_smoke.ssd_recurrence_check``, the card's SSD check, at a
    small size: chunked against ``ssd_decode_step`` in a loop, forward
    and gradient, within its bound."""
    out = ssd_recurrence_check(torch.device("cpu"), batch=1, seq=96,
                               heads=2, head_dim=8, state=16, chunk=32)
    assert out["finite"] and out["grad_dev"] <= out["bound"]
    assert out["y_dev"] <= out["bound"] and out["state_dev"] <= out["bound"]


def _bf16_tree(jcfg_bf, tree):
    """``tree`` with each leaf in the dtype the reference draws it in under
    ``jcfg_bf`` (bfloat16, but A_log, D and dt_bias float32), as numpy."""
    dtypes = jax.tree.map(lambda a: a.dtype, jax.eval_shape(
        lambda: jax_init_params(jcfg_bf, jax.random.PRNGKey(0))))
    return jax.tree.map(lambda a, d: np.asarray(jnp.asarray(a).astype(d)),
                        tree, dtypes)


def test_bf16_decode_with_a_float32_cache():
    """bfloat16 params: with a float32 cache the reference's
    ``decode_step`` raises ``TypeError``; the port's logits over 8 steps
    are finite and within ``BF16_LOGIT_BOUND`` of its float32 run (the
    unrounded params, float32 activations). With a bfloat16 cache port
    and reference agree within ``BF16_REL_BOUND`` of the largest
    |logit|."""
    jcfg, cfg = _cfgs()
    jbf, bf = _cfgs(dtype="bfloat16", param_dtype="bfloat16")
    tree = _tree(jcfg, 11)
    tree_bf = _bf16_tree(jbf, tree)
    jparams = jax.tree.map(jnp.asarray, tree_bf)
    params = load_lm_params(bf, tree_bf, device="cpu")
    mixer = params["segments"][0]["pos0"]["mixer"]
    assert mixer["wx"].dtype == torch.bfloat16
    assert mixer["A_log"].dtype == mixer["D"].dtype == \
        mixer["dt_bias"].dtype == torch.float32
    params32 = load_lm_params(cfg, tree, device="cpu")
    b, steps = 2, 8
    toks = np.random.default_rng(12).integers(
        0, cfg.vocab_size, size=(steps, b, 1)).astype(np.int32)
    pos = [np.full((b,), t, np.int32) for t in range(steps)]
    with pytest.raises(TypeError):
        jax_decode_step(jparams, jbf, jax_init_cache(jbf, b, 16,
                                                     dtype=jnp.float32),
                        jnp.asarray(toks[0]), jnp.asarray(pos[0]))
    cache = init_cache(bf, b, 16, dtype=torch.float32, device="cpu")
    cache32 = init_cache(cfg, b, 16, dtype=torch.float32, device="cpu")
    jcache = jax_init_cache(jbf, b, 16, dtype=jnp.bfloat16)
    cache16 = init_cache(bf, b, 16, dtype=torch.bfloat16, device="cpu")
    worst32 = worst16 = 0.0
    for t in range(steps):
        tok, p = torch.from_numpy(toks[t]), torch.from_numpy(pos[t])
        got, cache = decode_step(params, bf, cache, tok, p)
        assert got.dtype == torch.bfloat16
        assert cache["segments"][0]["pos0"]["conv"].dtype == torch.float32
        assert torch.isfinite(got[:, :cfg.vocab_size]).all()
        want32, cache32 = decode_step(params32, cfg, cache32, tok, p)
        worst32 = max(worst32, float((got.float() - want32)[
            :, :cfg.vocab_size].abs().max()))
        jwant, jcache = jax_decode_step(jparams, jbf, jcache,
                                        jnp.asarray(toks[t]),
                                        jnp.asarray(pos[t]))
        got16, cache16 = decode_step(params, bf, cache16, tok, p)
        jw = np.asarray(jwant.astype(jnp.float32))[:, :cfg.vocab_size]
        worst16 = max(worst16, float(np.abs(
            got16.float().numpy()[:, :cfg.vocab_size] - jw).max()
            / np.abs(jw).max()))
    print(f"bf16 decode: vs the float32 run {worst32:.3g} (bound "
          f"{BF16_LOGIT_BOUND}); bf16 cache, port vs reference "
          f"{worst16:.3g} of the largest |logit| (bound {BF16_REL_BOUND:.3g})")
    assert worst32 <= BF16_LOGIT_BOUND
    assert worst16 <= BF16_REL_BOUND
