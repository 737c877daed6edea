"""granite-4.0-h-small on the port (a ``PortModelConfig``: Mamba-2 and
NoPE attention, a dropless MoE over the experts a card holds beside a
shared expert, muP-style scalars) against the benchmark's plain
reference, ``portbench/reference/granite_hybrid.py``, on the CPU.

The configuration is the benchmark's file (one period of ten layers,
9 of 72 experts held) cut to a tiny width with the same period: d_model
64, 4 query and 2 KV heads of 16, 8 experts top-3, 3 held. Weights are
the benchmark's, drawn from a seed in float32. Tolerances: the port and
the reference compute the same float32 function in other orders (fused
products, the SSD's pairwise contractions, the scatter-add's order), so
logits agree to 1e-5 of their largest value and gradients to 1e-4 of
each leaf's norm (a leaf's gradient sums over every token's routes);
with any one setting dropped the logits fail their comparison.
"""

import copy
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, weights  # noqa: E402
from portbench.program import port_config  # noqa: E402
from portbench.reference import granite_hybrid as fam  # noqa: E402
from portbench.reference.tree import paths  # noqa: E402
from repro_torch.configs import (PORT_ONLY_ARCH_IDS, PortModelConfig,  # noqa: E402
                                 get_config)
from repro_torch.models import decode_step, forward, init_cache  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.serving.predictor import (ServeDriver,  # noqa: E402
                                           make_prefill_step)
from repro_torch.training import TrainState, make_train_step  # noqa: E402

SEED = 2 ** 31 + 34
LOGIT_TOL = 1e-5
GRAD_TOL = 1e-4
CUT = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
       "head_dim": 16, "intermediate_size": 24,
       "shared_intermediate_size": 40, "vocab_size": 300,
       "mamba_d_state": 16, "mamba_d_head": 16, "mamba_chunk_size": 16,
       "published_num_local_experts": 8, "num_local_experts": 3,
       "num_experts_per_tok": 3, "attention_multiplier": 1 / 16,
       "torch_dtype": "float32"}


def _spec(**over) -> dict:
    spec = copy.deepcopy(harness.config_spec(harness.load_manifest(),
                                             "granite-4.0-h-small"))
    spec.update(CUT)
    spec.update(over)
    return spec


def _params(spec: dict, tag: str = "") -> dict:
    return weights.make_params(spec, SEED, "cpu", "float32", tag=tag)


def _tokens(spec: dict, shape, name: str = "test") -> torch.Tensor:
    n = shape[0] * shape[1]
    return torch.from_numpy(weights.zipf_ids(SEED, name, n, spec["vocab_size"],
                                             1.0)).reshape(shape)


@torch.no_grad()
def _ref_logits(spec, params, tokens):
    return fam.head(params, spec, fam.hidden(params, spec, tokens,
                                             "float32"), "float32")


def _close(got, want, tol):
    scale = float(want.abs().max())
    return float((got - want).abs().max()) <= tol * scale


def test_registered_outside_the_references_list():
    """The port's own ids resolve through ``get_config`` as
    ``PortModelConfig``s; the published one at 40 layers and 72 experts,
    the card's share at one period and 9 held; the settings every other
    config has are class attributes, not fields."""
    full, share = (get_config(a) for a in PORT_ONLY_ARCH_IDS)
    assert isinstance(full, PortModelConfig) and full.num_layers == 40
    assert (share.num_layers, share.held_experts, share.num_experts) \
        == (10, 9, 72)
    assert full.held_experts == 72 and not full.use_rope
    qwen = get_config("qwen2-1.5b")
    assert "logits_scaling" not in dataclasses.asdict(qwen)
    assert qwen.logits_scaling == 1.0 and qwen.held_experts == 0


def test_param_counts_published_and_cut():
    """32.2 B uncut (as published), 2.41 B for the card's share; the
    active count takes the held experts at k * held / E of the routes."""
    full = get_config("granite-4.0-h-small").param_counts()
    share = get_config("granite-4.0-h-small-ep8").param_counts()
    assert round(full["total"] / 1e9, 1) == 32.2
    assert round(share["total"] / 1e9, 2) == 2.41
    assert 8.5e9 < full["active"] < 9.5e9
    per_expert = 3 * 4096 * 768
    assert full["total"] - share["total"] > 40 * 63 * per_expert


def test_port_config_of_the_file_is_the_registered_share():
    spec = harness.config_spec(harness.load_manifest(), "granite-4.0-h-small")
    assert port_config(spec) == get_config(spec["port_arch"])


def test_forward_logits_against_reference():
    spec = _spec()
    params, tokens = _params(spec), _tokens(spec, (2, 40))
    with torch.no_grad():
        got, metrics = forward(params, port_config(spec), tokens)
    want = _ref_logits(spec, params, tokens)
    assert _close(got[..., :spec["vocab_size"]], want, LOGIT_TOL)
    assert metrics["expert_counts"].shape == (3,)


def test_train_step_loss_and_every_gradient_against_reference():
    """Through ``make_train_step`` with Adam: the pre-update loss, and each
    leaf's gradient as the optimizer got it (``m / (1 - b1)``)."""
    spec = _spec()
    tokens = _tokens(spec, (2, 40))
    params = _params(spec)
    opt = get_optimizer("adam", lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    state = TrainState(params=params, slots=opt.init_slots_tree(params),
                       step=0)
    state, metrics = make_train_step(port_config(spec), optimizer=opt)(
        state, {"tokens": tokens})
    loss, grads = fam.loss_and_grads(_params(spec), spec, tokens)
    assert float(metrics["loss"]) == pytest.approx(loss, rel=1e-6)
    slots = dict(paths(state.slots))
    assert len(grads) == len(paths(state.params))
    for p, want in grads.items():
        got = slots[f"{p}/m"] / (1 - 0.9)
        err = float((got - want).norm() / want.norm().clamp_min(1e-30))
        assert err <= GRAD_TOL, (p, err)


def test_held_expert_with_no_rows_takes_a_zero_gradient():
    """Two tokens routed top-1 over 8 experts, 3 held: in every layer a
    held expert takes no row. The reference gives its weights a zero
    gradient (not none), and the port's train step the same zero, with
    every other leaf as in the comparison above."""
    spec = _spec(num_experts_per_tok=1)
    tokens = _tokens(spec, (1, 2))
    params = _params(spec)
    opt = get_optimizer("adam", lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    state = TrainState(params=params, slots=opt.init_slots_tree(params),
                       step=0)
    state, metrics = make_train_step(port_config(spec), optimizer=opt)(
        state, {"tokens": tokens})
    loss, grads = fam.loss_and_grads(_params(spec), spec, tokens)
    assert float(metrics["loss"]) == pytest.approx(loss, rel=1e-6)
    slots = dict(paths(state.slots))
    empty = 0
    for p, want in grads.items():
        assert want is not None, p
        if p.endswith("ffn/w_down"):                # (periods, held, F, D)
            empty += int((want.flatten(2).abs().amax(-1) == 0).sum())
        got = slots[f"{p}/m"] / (1 - 0.9)
        assert torch.isfinite(got).all(), p
        err = float((got - want).norm() / want.norm().clamp_min(1e-30))
        assert err <= GRAD_TOL, (p, err)
    assert empty >= port_config(spec).num_layers


def test_prefill_then_decode_through_cache_and_driver():
    """A prefill's logits, then the same tokens a step at a time through
    the cache, and through a ``ServeDriver`` with a hot swap, against the
    reference's full forward (the driver's served tokens are the
    reference's argmax)."""
    spec = _spec()
    cfg = port_config(spec)
    params, swap = _params(spec), _params(spec, tag="swap/")
    tokens = _tokens(spec, (2, 24))
    v = spec["vocab_size"]
    want = _ref_logits(spec, params, tokens)
    with torch.inference_mode():
        got = make_prefill_step(cfg)(params, {"tokens": tokens})
    assert _close(got[..., :v], want, LOGIT_TOL)
    cache = init_cache(cfg, 2, 32, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        steps = [decode_step(params, cfg, cache, tokens[:, t:t + 1],
                             torch.full((2,), t))[0]
                 for t in range(tokens.shape[1])]
    assert _close(torch.stack(steps, 1)[..., :v], want, LOGIT_TOL)
    driver = ServeDriver(cfg, params, batch=2, max_len=32,
                         cache_dtype=torch.float32, device="cpu")
    half = tokens.shape[1] // 2
    with torch.no_grad():
        served = [driver.step(tokens[:, t:t + 1])[:, 0] for t in range(half)]
        driver.hot_swap(swap)
        served += [driver.step(tokens[:, t:t + 1])[:, 0]
                   for t in range(half, tokens.shape[1])]
    assert torch.equal(torch.stack(served[:half], 1),
                       want[:, :half].argmax(-1))
    # after the swap: the new weights over the old weights' cache, as the
    # port's eager decode computes it
    cache = init_cache(cfg, 2, 32, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        mixed = [decode_step(params if t < half else swap, cfg, cache,
                             tokens[:, t:t + 1], torch.full((2,), t))[0]
                 for t in range(tokens.shape[1])]
    assert torch.equal(torch.stack(served[half:], 1),
                       torch.stack(mixed[half:], 1).argmax(-1))


DROPPED = {"use_rope": True, "embedding_multiplier": 1.0,
           "residual_multiplier": 1.0, "attention_multiplier": 0.0,
           "logits_scaling": 1.0, "norm_eps": 1e-6, "shared_expert_ff": 0}


@pytest.mark.parametrize("field", sorted(DROPPED))
def test_each_setting_matters(field):
    """With NoPE or one multiplier (or the norm's eps, or the shared
    expert) dropped, the port's logits fail the comparison."""
    spec = _spec()
    params, tokens = _params(spec), _tokens(spec, (2, 40))
    cfg = dataclasses.replace(port_config(spec), **{field: DROPPED[field]})
    with torch.no_grad():
        got, _ = forward(params, cfg, tokens)
    want = _ref_logits(spec, params, tokens)
    assert not _close(got[..., :spec["vocab_size"]], want, LOGIT_TOL)


def _layer_inputs(spec):
    """One MoE layer's weights (repeat 0 of position 0) and tokens."""
    params = _params(spec)
    p = {k: (v[0] if not isinstance(v, dict) else
             {kk: vv[0] for kk, vv in v.items()})
         for k, v in params["segments"][0]["pos0"]["ffn"].items()}
    g = torch.Generator().manual_seed(3)
    return p, torch.randn((2, 20, spec["hidden_size"]), generator=g)


def test_dropless_against_a_per_token_loop():
    spec = _spec()
    cfg = port_config(spec)
    p, x = _layer_inputs(spec)
    with torch.no_grad():
        got, _, counts = moe_lib.moe_ffn(p, x, cfg)
        xt = x.reshape(-1, x.shape[-1])
        idx, gate, _ = moe_lib.route(p["router"], xt, cfg)
        want = moe_lib._shared_expert(p["shared"], xt)
        rows = torch.zeros(cfg.held_experts, dtype=torch.int32)
        for t in range(xt.shape[0]):
            for j in range(cfg.experts_per_token):
                e = int(idx[t, j])
                if e < cfg.held_experts:
                    rows[e] += 1
                    h = torch.nn.functional.silu(xt[t] @ p["w_gate"][e]) \
                        * (xt[t] @ p["w_up"][e])
                    want[t] += gate[t, j] * (h @ p["w_down"][e])
    assert torch.allclose(got.reshape(-1, x.shape[-1]), want, atol=1e-5,
                          rtol=1e-5)
    assert torch.equal(counts, rows)


def test_dropless_against_the_capacity_path_where_nothing_drops():
    """Every expert held and a capacity over every token: the capacity
    path drops nothing, and the two dispatches give one function."""
    spec = _spec(num_local_experts=8)
    p, x = _layer_inputs(spec)
    cfg = dataclasses.replace(port_config(spec), shared_expert_ff=0)
    capacity = dataclasses.replace(cfg, moe_dropless=False,
                                   moe_capacity_factor=8.0)
    with torch.no_grad():
        got, aux, counts = moe_lib.moe_ffn(p, x, cfg)
        want, aux_c, counts_c = moe_lib.moe_ffn(p, x, capacity)
    assert torch.allclose(got, want, atol=1e-6, rtol=1e-5)
    assert torch.equal(counts, counts_c) and float(aux) == float(aux_c)


def test_eight_shares_add_up_to_the_uncut_layer():
    """The 72-wide router's experts over 8 cards (here 8 experts, one a
    card): each share routes over all of them and computes its own;
    their outputs, with the shared expert counted once, add up to what
    the reference gives for the whole layer."""
    spec = _spec(num_local_experts=8)
    p, x = _layer_inputs(spec)
    with torch.no_grad():
        whole = fam.moe(p, x, spec, "float32")[0]
        shares = 8
        cfg = dataclasses.replace(port_config(spec), experts_held=1)
        total = -(shares - 1) * moe_lib._shared_expert(
            p["shared"], x.reshape(-1, x.shape[-1])).reshape(x.shape)
        for s in range(shares):
            mine = dict(p, router=torch.roll(p["router"], -s, dims=1),
                        w_gate=p["w_gate"][s:s + 1], w_up=p["w_up"][s:s + 1],
                        w_down=p["w_down"][s:s + 1])
            total = total + moe_lib.moe_ffn(mine, x, cfg)[0]
    assert torch.allclose(total, whole, atol=1e-5, rtol=1e-5)


def test_moe_span_nests_under_the_train_step_with_its_rows():
    """Each MoE layer's ``layer.moe`` spans (the forward's and the remat
    recompute's) lie under ``train.step``; the forward's carry
    ``held_rows`` and ``max_rows``, read by the tracer's export (the
    recompute stops once the backward's saved tensors are made again,
    before the rows are noted)."""
    spec = _spec()
    cfg = port_config(spec)
    params, tokens = _params(spec), _tokens(spec, (2, 40))
    opt = get_optimizer("adam")
    state = TrainState(params=params, slots=opt.init_slots_tree(params),
                       step=0)
    obs_trace.configure(enabled=True)
    try:
        make_train_step(cfg, optimizer=opt)(state, {"tokens": tokens})
        spans = obs_trace.get_tracer().export()
    finally:
        obs_trace.disable()
    by_id = {s["span"]: s for s in spans}
    (root,) = [s for s in spans if s["name"] == "train.step"]
    moes = [s for s in spans if s["name"] == "layer.moe"]
    assert len(moes) == 2 * cfg.num_layers          # forward and recompute
    for s in moes:
        node = s
        while node["parent"] and node["span"] != root["span"]:
            node = by_id[node["parent"]]
        assert node["span"] == root["span"]
    noted = [s["args"] for s in moes if "held_rows" in s.get("args", {})]
    assert len(noted) == cfg.num_layers
    for args in noted:
        rows, top = args["held_rows"], args["max_rows"]
        assert isinstance(rows, int) and 0 < top <= rows <= 80 * 3


@pytest.fixture
def cuda():
    """The CUDA device; decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch._grouped_mm takes bf16 there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_dropless_layer_on_card_against_float32(cuda):
    """The dropless layer in bf16 on the card (one ``torch._grouped_mm``
    a weight) against the same bf16 values in float32 on the CPU: the
    output and the gradients of the input and of every weight within
    3e-2 of each one's largest value (bf16 rounds the products and the
    hidden rows). The allocator's blocks hold NaN first, so a row the
    grouped products leave unwritten would show if it reached a token, a
    gate or a weight."""
    spec = _spec()
    cfg = port_config(spec)
    p, x = _layer_inputs(spec)
    p = {k: ({kk: vv.bfloat16().float() for kk, vv in v.items()}
             if isinstance(v, dict) else v.bfloat16().float())
         for k, v in p.items() if k != "norm"}     # the block applies it
    x = x.bfloat16().float()
    r = torch.randn(x.shape, generator=torch.Generator().manual_seed(4))

    def run(p, x, r):
        leaves = [x] + [v for v in p.values() if not isinstance(v, dict)] \
            + list(p["shared"].values())
        for v in leaves:
            v.requires_grad_(True)
        out = moe_lib.moe_ffn(p, x, cfg)[0]
        return [out] + list(torch.autograd.grad((out.float() * r).sum(),
                                                leaves))

    for size in (1 << 12, 1 << 16, 1 << 24):       # both allocator pools
        [torch.full((size,), float("nan"), device=cuda) for _ in range(8)]
    want = run(p, x, r)
    on_card = {k: ({kk: vv.detach().to(cuda, torch.bfloat16)
                    for kk, vv in v.items()} if isinstance(v, dict)
                   else v.detach().to(cuda, torch.bfloat16))
               for k, v in p.items()}
    got = run(on_card, x.to(cuda, torch.bfloat16), r.to(cuda))
    for g, w in zip(got, want):
        g, w = g.detach().float().cpu(), w.detach()
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= 3e-2 * float(w.abs().max())


@pytest.mark.cuda
def test_held_expert_with_no_rows_on_card(cuda):
    """The dropless products on the card with held expert 1 routed no
    row (an empty segment between two others): its weights' gradients
    exactly zero, and the output and every other gradient within 3e-2
    of each one's largest value from the same bf16 values in float32
    on the CPU, as above. The allocator's blocks hold NaN first."""
    spec = _spec()
    cfg = port_config(spec)
    p, x = _layer_inputs(spec)
    p = {k: v.bfloat16().float() for k, v in p.items()
         if k in ("w_gate", "w_up", "w_down")}
    xt = x.reshape(-1, x.shape[-1]).bfloat16().float()
    logits = torch.randn((xt.shape[0], cfg.num_experts),
                         generator=torch.Generator().manual_seed(5))
    logits[:, 1] = -float("inf")
    top, idx = logits.topk(cfg.experts_per_token, dim=-1)
    gate = torch.softmax(top, dim=-1)
    r = torch.randn(xt.shape, generator=torch.Generator().manual_seed(6))

    def run(p, xt, idx, gate, r):
        leaves = [xt] + list(p.values())
        for v in leaves:
            v.requires_grad_(True)
        out, counts = moe_lib._dropless(p, xt, idx, gate, cfg)
        return [out] + list(torch.autograd.grad((out.float() * r).sum(),
                                                leaves)), counts

    for size in (1 << 12, 1 << 16, 1 << 24):       # both allocator pools
        [torch.full((size,), float("nan"), device=cuda) for _ in range(8)]
    want, counts = run(p, xt, idx, gate, r)
    assert int(counts[1]) == 0 and int(counts[0]) > 0 and int(counts[2]) > 0
    on_card = {k: v.detach().to(cuda, torch.bfloat16) for k, v in p.items()}
    got, _ = run(on_card, xt.to(cuda, torch.bfloat16), idx.to(cuda),
                 gate.to(cuda), r.to(cuda))
    for g, w in zip(got, want):
        g, w = g.detach().float().cpu(), w.detach()
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= 3e-2 * float(w.abs().max())
    for g in got[2:]:
        assert torch.equal(g[1], torch.zeros_like(g[1]))
