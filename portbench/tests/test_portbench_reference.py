"""The plain references against the port, in float32 on the CPU at a
reduced size: forward logits, the loss and every leaf's gradient, an
Adam step, and greedy decode against a seeded cache across a hot swap.
The two were written apart (the reference reads only the benchmark's
weights), so agreement to float32 rounding checks both."""

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.program import port_config
from portbench.reference import common, dense, mamba2
from portbench.reference.tree import paths
from portbench.tests import tiny

FAMILIES = {"qwen2-1.5b": dense, "mamba2-1.3b": mamba2}


def _setup(config: str):
    spec = tiny.spec(config, "float32")
    params = weights.make_params(spec, tiny.SEED, "cpu", "float32")
    tokens = torch.from_numpy(weights.zipf_ids(tiny.SEED, "test", 2 * 40,
                                               spec["vocab_size"], 1.0)
                              ).reshape(2, 40)
    return spec, params, tokens


def _close(got, want, rel):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rel * max(scale, 1e-12)


@pytest.mark.parametrize("config", sorted(FAMILIES))
def test_forward_logits(config):
    from repro_torch.models import forward
    spec, params, tokens = _setup(config)
    fam = FAMILIES[config]
    with torch.no_grad():
        got, _ = forward(params, port_config(spec), tokens)
        want = fam.head(params, spec, fam.hidden(params, spec, tokens,
                                                 "float32"), "float32")
    _close(got[..., :spec["vocab_size"]], want, 1e-5)


@pytest.mark.parametrize("config", sorted(FAMILIES))
def test_loss_and_grads(config):
    from repro_torch.training import loss_and_grads
    spec, params, tokens = _setup(config)
    loss, _, grads = loss_and_grads(params, port_config(spec),
                                    {"tokens": tokens})
    want_loss, want = FAMILIES[config].loss_and_grads(
        weights.make_params(spec, tiny.SEED, "cpu", "float32"), spec, tokens)
    assert abs(float(loss) - want_loss) <= 1e-6 * abs(want_loss)
    got = dict(paths(grads))
    assert set(got) == set(want)
    for p in want:
        _close(got[p], want[p], 1e-4)


def test_adam_step():
    from repro_torch.optim import get_optimizer
    spec, params, _ = _setup("qwen2-1.5b")
    opt = {"lr": 1e-3, "b1": 0.9, "b2": 0.999, "eps": 1e-8}
    port = get_optimizer("adam", **opt)
    slots = port.init_slots_tree(params)
    mine = {p: t.clone() for p, t in paths(params)}
    m = {p: torch.zeros_like(t) for p, t in mine.items()}
    v = {p: torch.zeros_like(t) for p, t in mine.items()}
    gen = torch.Generator().manual_seed(5)
    for step in range(3):
        grads = {p: torch.randn(t.shape, generator=gen) for p, t in mine.items()}
        tree = {}
        for p, g in grads.items():
            weights.set_path(tree, p, g)
        port.update_tree(params, slots, tree, step)
        for p, t in mine.items():
            common.adam_(t, grads[p], m[p], v[p], step, opt)
    for p, t in paths(params):
        _close(t, mine[p], 1e-6)


def test_decode_across_hot_swap():
    """``ServeDriver`` over a seeded cache, a swap every 3 steps, against
    ``decode_logits`` over the same rows and fed tokens."""
    from repro_torch.serving.predictor import ServeDriver
    spec = tiny.spec("qwen2-1.5b", "float32")
    sets = [weights.make_params(spec, tiny.SEED, "cpu", "float32", tag=t)
            for t in ("A/", "B/")]
    batch, rows, every, steps = 3, 64, 3, 8
    start = np.array([20, 33, 41])
    shape = (batch, rows, spec["num_key_value_heads"], spec["head_dim"])
    drv = ServeDriver(cfg=port_config(spec), params=sets[0], batch=batch,
                      max_len=rows, cache_dtype=torch.float32, device="cpu")
    entry = drv.cache["segments"][0]["pos0"]
    for layer in range(spec["num_hidden_layers"]):
        for w in ("k", "v"):
            entry[w][layer].copy_(weights.cache_rows(
                tiny.SEED, layer, w, shape, "cpu", torch.float32))
    drv.pos = torch.as_tensor(start, dtype=torch.int32)
    logits, fed = [], [torch.tensor([[5], [7], [11]], dtype=torch.int32)]
    drv.step_fn = (lambda f: lambda *a: logits.append(f(*a)[0]) or
                   (logits[-1], a[1]))(drv.step_fn)
    for t in range(steps):
        if t and t % every == 0:
            drv.hot_swap(sets[(t // every) % 2])
        fed.append(drv.step(fed[-1]))
    got = torch.stack(logits, 1)[..., :spec["vocab_size"]]
    for b in range(batch):
        prefix = []
        for layer in range(spec["num_hidden_layers"]):
            k, v = (weights.cache_rows(tiny.SEED, layer, w, shape, "cpu",
                                       torch.float32)[b, :start[b]]
                    for w in ("k", "v"))
            prefix.append((k, v))
        toks = torch.cat([f[b] for f in fed[:-1]]).long()
        want = dense.decode_logits(sets, spec, prefix, toks, int(start[b]),
                                   every)
        _close(got[b], want, 1e-5)


def test_fp8_control_rounds():
    """The control's rounding keeps 3 mantissa bits under one scale."""
    x = torch.tensor([1.0, 1.0625, -300.0, 448.0, 1e-3])
    q = common.fp8_round(x)
    assert float(q[3]) == 448.0 and float(q[1]) == 1.0
    assert float(q[2]) == -288.0
