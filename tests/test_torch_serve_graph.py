"""``ServeDriver``'s decode step replayed from a CUDA graph.

On the CPU the driver steps eagerly, and every ``decode.dispatch`` says
so (``graph="eager"``); a ``pos`` assigned after construction is copied
into the driver's position buffer and leaves the caller's tensor as it
was. On a card (the ``cuda`` tests, skipped without one) a driver that
captures is held bit-equal to one that steps eagerly (its step function
the caller's) over the same seeded cache, for a tiny configuration of
each family the serving tests cover: dense GQA, SSM, MoE,
encoder-decoder with a cross cache, hybrid with the int8 cache. Both run
80 steps with a hot swap between two weight sets every 16; the tokens
and the final cache must be bit-equal, the caller's weights unchanged, a
``pos`` assigned after construction honoured, and after the warm-up step
and the capture every step a replay. A cache assigned anew drops the
graph and the driver captures again; without room for a second copy of
the weights it stays eager. The file imports nothing of JAX, so it also
runs where only the port is installed:

    PYTHONPATH=src python -m pytest tests/test_torch_serve_graph.py -q --noconftest
"""

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.configs import get_config, reduced
from repro_torch.models import init_cache, init_params
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.predictor import ServeDriver, make_serve_step

# each family the serving tests cover; True: the int8 KV cache
FAMILIES = {"qwen2-1.5b": False, "mamba2-1.3b": False,
            "granite-moe-3b-a800m": False, "whisper-medium": False,
            "jamba-1.5-large-398b": True}
BATCH, MAX_LEN = 4, 128
STARTS = (3, 17, 9, 30)                 # a position assigned per sequence


@pytest.fixture
def cuda():
    """The CUDA device; decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (nvcc builds the kernels on first "
                    "use)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _tracer_on():
    """The port's tracer recording every span of the test."""
    obs_trace.configure(enabled=True)
    yield
    obs_trace.disable()


def _modes() -> list:
    """The ``graph`` attribute of every ``decode.dispatch`` since the
    last call, in order."""
    tr = obs_trace.get_tracer()
    out = [s["args"]["graph"] for s in tr.export()
           if s["name"] == "decode.dispatch"]
    tr.clear()
    return out


def _seed_cache(cache: dict, gen: torch.Generator) -> None:
    """Every cache leaf filled from ``gen``: int8 codes over their range,
    floats N(0, 1) (K/V rows, scales, SSM states, the cross cache)."""
    for t in tree_flatten(cache)[0]:
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                  device=t.device, dtype=torch.int8))
        else:
            t.copy_(torch.randn(t.shape, generator=gen, device=t.device,
                                dtype=t.dtype))


def _driver(cfg, params, device, kv_quant: bool, **kw) -> ServeDriver:
    drv = ServeDriver(cfg=cfg, params=params, batch=BATCH, max_len=MAX_LEN,
                      cache_dtype=torch.float32, device=device, **kw)
    if kv_quant:
        drv.cache = init_cache(cfg, BATCH, MAX_LEN, dtype=torch.float32,
                               device=device, kv_quant=True)
    _seed_cache(drv.cache, torch.Generator(device=device).manual_seed(5))
    drv.pos = torch.tensor(STARTS, dtype=torch.int32, device=device)
    return drv


def _serve(drv: ServeDriver, sets: list, steps: int, swap_every: int,
           between=None) -> tuple:
    """``steps`` greedy steps from seeded tokens, hot-swapping to the
    other weight set every ``swap_every``; ``between(drv, t)`` runs
    before step t. Returns ``(tokens (B, steps), modes)``."""
    assigned = drv.pos
    tok = torch.tensor([[1], [7], [42], [3]], dtype=torch.int32,
                       device=drv.device)
    _modes()
    with torch.no_grad():
        for t in range(steps):
            if t and t % swap_every == 0:
                drv.hot_swap(sets[(t // swap_every) % 2])
            if between is not None:
                between(drv, t)
            tok = drv.step(tok)
    assert torch.equal(assigned, torch.tensor(STARTS, dtype=torch.int32,
                                              device=drv.device))
    assert drv.pos.tolist() == [s + steps for s in STARTS]
    return np.stack(drv.generated, axis=1), _modes()


def _sets(cfg, device) -> list:
    return [init_params(cfg, torch.Generator(device=device).manual_seed(s))
            for s in (0, 1)]


def _equal_trees(a, b) -> bool:
    la, sa = tree_flatten(a)
    lb, sb = tree_flatten(b)
    return sa == sb and all(torch.equal(x, y) for x, y in zip(la, lb))


def _stepped_by_hand(cfg, sets: list, device, kv_quant: bool,
                     steps: int, swap_every: int) -> np.ndarray:
    """The same stream through the step function alone, on the same
    seeded cache: explicit positions from ``STARTS``, the weight set
    passed at each step."""
    step = make_serve_step(cfg)
    cache = _driver(cfg, sets[0], device, kv_quant).cache
    pos = torch.tensor(STARTS, dtype=torch.int32, device=device)
    tok = torch.tensor([[1], [7], [42], [3]], dtype=torch.int32,
                       device=device)
    out = []
    with torch.no_grad():
        for t in range(steps):
            logits, cache = step(sets[(t // swap_every) % 2], cache, tok,
                                 pos)
            pos = pos + 1
            tok = logits.argmax(dim=-1).to(torch.int32)[:, None]
            out.append(tok[:, 0].cpu().numpy())
    return np.stack(out, axis=1)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_cpu_driver_steps_eagerly(arch):
    """On the CPU every step is eager, the hot swaps take the caller's
    trees, and an assigned ``pos`` is honoured: the tokens equal those
    of the step function driven by hand from the same positions."""
    cfg, dev = reduced(get_config(arch)), torch.device("cpu")
    sets = _sets(cfg, dev)
    drv = _driver(cfg, sets[0], dev, FAMILIES[arch])
    tokens, modes = _serve(drv, sets, steps=6, swap_every=4)
    assert modes == ["eager"] * 6
    assert drv.params is sets[1]
    np.testing.assert_array_equal(
        tokens, _stepped_by_hand(cfg, sets, dev, FAMILIES[arch], 6, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_replayed_step_matches_eager_on_card(cuda, arch):
    cfg, kv_quant = reduced(get_config(arch)), FAMILIES[arch]
    sets = _sets(cfg, cuda)
    callers = tree_map(torch.clone, sets)
    eager = _driver(cfg, sets[0], cuda, kv_quant,
                    step_fn=make_serve_step(cfg))
    want, eager_modes = _serve(eager, sets, steps=80, swap_every=16)
    graph = _driver(cfg, sets[0], cuda, kv_quant)
    got, modes = _serve(graph, sets, steps=80, swap_every=16)
    assert eager_modes == ["eager"] * 80
    assert modes == ["eager", "capture"] + ["replay"] * 78
    np.testing.assert_array_equal(got, want)
    assert _equal_trees(graph.cache, eager.cache)
    assert _equal_trees(sets, callers)
    assert graph.params is not sets[0] and graph.params is not sets[1]


@pytest.mark.cuda
def test_new_cache_captures_again_on_card(cuda):
    """A cache assigned after the capture drops the graph: the driver
    warms up on it and captures again, and serves what an eager driver
    serves."""
    cfg = reduced(get_config("qwen2-1.5b"))
    sets = _sets(cfg, cuda)

    def recache(drv, t):
        if t == 20:
            drv.cache = tree_map(torch.clone, drv.cache)

    eager = _driver(cfg, sets[0], cuda, False, step_fn=make_serve_step(cfg))
    want, _ = _serve(eager, sets, steps=40, swap_every=16, between=recache)
    graph = _driver(cfg, sets[0], cuda, False)
    got, modes = _serve(graph, sets, steps=40, swap_every=16,
                        between=recache)
    assert modes == ["eager", "capture"] + ["replay"] * 18 \
        + ["eager", "capture"] + ["replay"] * 18
    np.testing.assert_array_equal(got, want)
    assert _equal_trees(graph.cache, eager.cache)


@pytest.mark.cuda
def test_no_room_for_the_weights_stays_eager_on_card(cuda, monkeypatch):
    cfg = reduced(get_config("qwen2-1.5b"))
    sets = _sets(cfg, cuda)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (0, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: torch.cuda.memory_allocated())
    drv = _driver(cfg, sets[0], cuda, False)
    _, modes = _serve(drv, sets, steps=20, swap_every=16)
    assert modes == ["eager"] * 20
    assert drv.params is sets[1]
