"""The port's ``models/moe.py`` against the JAX package's, on the CPU, at
``reduced(get_config(arch))`` for granite-moe-3b-a800m and dbrx-132b (4
experts, top-2, d_model 256, float32), inputs made from a seed with
NumPy.

Held: ``moe_capacity`` equal; ``route``'s expert indices equal, gates and
aux within 1e-6; ``_slot_positions`` bit-equal (a case with every
assignment on one expert included); the dispatch buffers bit-equal and
the kept assignments equal, assignment for assignment, at capacity
factors 1.25 (routing skewed onto one expert, so it overflows), 8.0 and
0.1, with ``moe_dispatch_groups`` 1 and 2; ``moe_ffn``'s output within
rtol = atol = 1e-5 and its counts equal; the gradients of ``out.sum() +
aux`` with respect to x, the router and the three expert weights within
1e-4 of the largest magnitude, against ``jax.grad``; two calls equal to
the bit. The port's row gathers run their plain versions on CPU tensors
(no kernel launches).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import moe as jax_moe
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops as port_ops
from repro_torch.models import moe

ARCHS = ["granite-moe-3b-a800m", "dbrx-132b"]
FACTORS = [1.25, 8.0, 0.1]
NEAR_TIE = 1e-5             # a flipped route with a smaller gap is rounding


def _cfgs(arch, factor=1.25, groups=1):
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)),
                               moe_capacity_factor=factor,
                               moe_dispatch_groups=groups)
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              moe_capacity_factor=factor,
                              moe_dispatch_groups=groups)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)  # a copy
    return jcfg, cfg


def _inputs(cfg, seed: int, *, b=2, s=32, skew=False):
    """Expert weights and x (B, S, D) from ``seed``, the router at the
    model's init scale (variance 1 / d_model); ``skew`` biases the router
    towards expert 0 so that it overflows at factor 1.25."""
    rng = np.random.default_rng(seed)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    p = {"router": rng.standard_normal((d, e), dtype=np.float32) * d ** -0.5,
         "w_gate": 0.05 * rng.standard_normal((e, d, f), dtype=np.float32),
         "w_up": 0.05 * rng.standard_normal((e, d, f), dtype=np.float32),
         "w_down": 0.05 * rng.standard_normal((e, f, d), dtype=np.float32)}
    x = rng.standard_normal((b, s, d), dtype=np.float32)
    if skew:
        x += 0.5
        p["router"][:, 0] += 0.02
    return p, x


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree, grad=False):
    return {k: torch.from_numpy(v.copy()).requires_grad_(grad)
            for k, v in tree.items()}


def assert_routes_equal(got: np.ndarray, want: np.ndarray,
                        probs: np.ndarray) -> None:
    """Expert indices equal, except where the reference's k-th and
    (k+1)-th probabilities lie within ``NEAR_TIE`` of each other (each
    such flip is printed with its gap)."""
    k = want.shape[-1]
    flipped = np.nonzero((got != want).any(-1))[0]
    top = -np.sort(-probs, axis=-1)
    for t in flipped:
        gap = float(top[t, k - 1] - top[t, k]) if k < probs.shape[-1] \
            else 0.0
        print(f"route of token {t} flipped: {got[t]} vs {want[t]}, gap "
              f"{gap:.3g}")
        assert gap < NEAR_TIE, f"token {t}: a flip at gap {gap}"


@pytest.mark.parametrize("tokens", [1, 4, 48, 64, 4096])
@pytest.mark.parametrize("factor", FACTORS)
def test_moe_capacity_equal(tokens, factor):
    jcfg, cfg = _cfgs("granite-moe-3b-a800m", factor)
    full_j = dataclasses.replace(jax_get_config("granite-moe-3b-a800m"),
                                 moe_capacity_factor=factor)
    full = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                               moe_capacity_factor=factor)
    assert moe.moe_capacity(tokens, cfg) == \
        jax_moe.moe_capacity(tokens, jcfg)
    assert moe.moe_capacity(tokens, full) == \
        jax_moe.moe_capacity(tokens, full_j)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    jcfg, cfg = _cfgs(arch)
    p, x = _inputs(cfg, 1)
    xt = x.reshape(-1, cfg.d_model)
    jidx, jgate, jaux = jax_moe.route(jnp.asarray(p["router"]),
                                      jnp.asarray(xt), jcfg)
    idx, gate, aux = moe.route(torch.from_numpy(p["router"]),
                               torch.from_numpy(xt), cfg)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(xt) @ p["router"], -1))
    assert_routes_equal(idx.numpy(), np.asarray(jidx), probs)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert gate.dtype == aux.dtype == torch.float32
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("case", ["random", "one expert", "two experts",
                                  "sorted", "empty experts"])
def test_slot_positions_bit_equal(case):
    rng = np.random.default_rng(3)
    e = 8
    flat = {"random": rng.integers(0, e, 200),
            "one expert": np.full(200, 5),
            "two experts": rng.choice([2, 6], 200),
            "sorted": np.sort(rng.integers(0, e, 200)),
            "empty experts": rng.choice([0, 7], 64)}[case].astype(np.int32)
    want = np.asarray(jax_moe._slot_positions(jnp.asarray(flat), e))
    got = moe._slot_positions(torch.from_numpy(flat).long(), e)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _ref_dispatch(jcfg, xt, idx, gate, cap, groups):
    """The reference's buffers (G, E, C, D) and keep (G, T/G * k)."""
    t, k = idx.shape
    xg = jnp.asarray(xt).reshape(groups, t // groups, -1)
    ig = jnp.asarray(idx).reshape(groups, t // groups, k)
    gg = jnp.asarray(gate).reshape(groups, t // groups, k)
    buf, _, _, keep, _ = jax.vmap(
        lambda a, b_, c: jax_moe._dispatch(a, b_, c, cap, jcfg))(xg, ig, gg)
    return np.asarray(buf), np.asarray(keep)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_keeps_the_references_assignments(arch, factor, groups):
    """The same routes into the dispatch: the buffers bit-equal (the
    port's (E, G*C, D) is the reference's (G, E, C, D) with the first two
    axes swapped) and the same assignments kept; at factor 1.25 the
    skewed routing overflows expert 0."""
    jcfg, cfg = _cfgs(arch, factor, groups)
    p, x = _inputs(cfg, 4, skew=True)
    xt = x.reshape(-1, cfg.d_model)
    t = xt.shape[0]
    idx, gate, _ = moe.route(torch.from_numpy(p["router"]),
                             torch.from_numpy(xt), cfg)
    cap = moe.moe_capacity(t // groups, cfg)
    buf, rows, keep, counts = moe._dispatch(torch.from_numpy(xt), idx, cap,
                                            cfg, groups)
    want_buf, want_keep = _ref_dispatch(jcfg, xt, idx.numpy(), gate.numpy(),
                                        cap, groups)
    np.testing.assert_array_equal(keep.numpy(), want_keep.reshape(-1))
    got = buf.view(cfg.num_experts, groups, cap, -1).transpose(0, 1)
    np.testing.assert_array_equal(got.numpy(), want_buf)
    if factor < 8.0:
        assert not keep.all()                   # the case drops
    else:
        assert keep.all()
    e = idx.reshape(-1)
    np.testing.assert_array_equal(counts.numpy(), np.bincount(
        e[keep].numpy(), minlength=cfg.num_experts))
    slot = rows % cap
    assert ((slot == 0) | keep).all()


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("skew", [False, True])
def test_moe_ffn_matches_reference(arch, factor, groups, skew):
    jcfg, cfg = _cfgs(arch, factor, groups)
    p, x = _inputs(cfg, 5, skew=skew)
    wout, waux, wcounts = jax_moe.moe_ffn(_jax(p), jnp.asarray(x), jcfg)
    before = port_ops.launch_counts()
    out, aux, counts = moe.moe_ffn(_torch(p), torch.from_numpy(x), cfg)
    assert port_ops.launch_counts() == before          # plain versions
    assert out.shape == x.shape and counts.dtype == torch.int32
    np.testing.assert_allclose(out.numpy(), np.asarray(wout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(wcounts))


@pytest.mark.parametrize("factor,skew", [(1.25, True), (8.0, False),
                                         (0.1, False)])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_gradients_match_jax(arch, factor, skew):
    """d(out.sum() + aux) / d(x, router, w_gate, w_up, w_down) within 1e-4
    of each gradient's largest magnitude."""
    jcfg, cfg = _cfgs(arch, factor)
    p, x = _inputs(cfg, 6, skew=skew)

    def jloss(jp, jx):
        out, aux, _ = jax_moe.moe_ffn(jp, jx, jcfg)
        return out.sum() + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(_jax(p), jnp.asarray(x))
    tp, tx = _torch(p, grad=True), torch.from_numpy(x).requires_grad_(True)
    out, aux, _ = moe.moe_ffn(tp, tx, cfg)
    (out.sum() + aux).backward()
    pairs = [("x", tx.grad, jgx)] + [(k, tp[k].grad, jgp[k]) for k in p]
    for name, got, want in pairs:
        want = np.asarray(want)
        dev = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
        print(f"{arch} {factor}: d/d{name} {dev:.3g} of the largest")
        assert dev <= 1e-4, name


def test_two_calls_equal_to_the_bit():
    _, cfg = _cfgs("granite-moe-3b-a800m", 1.25)
    p, x = _inputs(cfg, 7, skew=True)
    runs = []
    for _ in range(2):
        tp = _torch(p, grad=True)
        tx = torch.from_numpy(x).requires_grad_(True)
        out, aux, counts = moe.moe_ffn(tp, tx, cfg)
        (out.sum() + aux).backward()
        runs.append([out.detach(), aux.detach(), counts, tx.grad]
                    + [tp[k].grad for k in sorted(tp)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
