"""The port's span tracer (``repro_torch.obs.trace``) on the CPU.

It records only under a ``torch.profiler`` session or when turned on
(``configure(enabled=False)`` keeps it off even under a profiler), on the
profiler's clock; open spans nest per thread, and the ring takes spans
from many threads at once. On tiny qwen2-like and mamba2-like configs
under a profiler, the LM paths yield their spans: a train step its
backward, optimizer and every layer's mixer (forward and remat
recompute), a prefill step its head, a driver's decode step its dispatch
and read-back; tracing does not change the served tokens. On the CPU no
span has a device interval."""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import get_config, reduced
from repro_torch.models import init_params
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.predictor import ServeDriver, make_prefill_step
from repro_torch.training import init_train_state, make_train_step

ARCHS = ["qwen2-1.5b", "mamba2-1.3b"]
LAYERS = 2


@pytest.fixture(autouse=True)
def _default_tracer():
    obs_trace.disable()
    yield
    obs_trace.disable()


def _profiled(fn):
    """``fn()`` inside a CPU profiler session: ``(result, profile)``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _by_name(spans: list) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def _inside(inner: dict, outer: dict) -> bool:
    return outer["t0"] <= inner["t0"] and inner["t1"] <= outer["t1"]


@pytest.mark.parametrize("enabled", [None, False, True])
@pytest.mark.parametrize("profiled", [False, True])
def test_recording_follows_the_profiler_unless_configured(enabled,
                                                          profiled):
    tr = obs_trace.configure(enabled=enabled)
    on = profiled if enabled is None else enabled

    def work():
        with tr.span("x", device=True) as sp:
            pass
        return sp

    sp = _profiled(work)[0] if profiled else work()
    assert tr.enabled is bool(enabled)   # no session open any more
    assert (sp is obs_trace._NULL_SPAN) is not on
    assert [s["name"] for s in tr.export()] == (["x"] if on else [])


@pytest.mark.parametrize("how", ["instant", "record"])
def test_default_tracer_off_without_a_profiler(how):
    tr = obs_trace.get_tracer()
    assert not tr.enabled
    if how == "instant":
        assert tr.instant("mark") == 0
    else:
        assert tr.record("queue", t0=0.0, t1=1.0) == 0
    assert tr.export() == [] and tr._buf is None


def test_spans_lie_on_the_profilers_clock():
    """A span around a ``record_function`` starts within 0.5 ms of that
    event's ``start_ns()`` and ends within 0.5 ms of its end (the first
    ranges of a session pay the profiler's own set-up)."""
    tr = obs_trace.get_tracer()

    def work():
        for i in range(3):
            with tr.span(f"span{i}"):
                with record_function(f"range{i}"):
                    torch.ones(64).sum()

    _, prof = _profiled(work)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    spans = {s["name"]: s for s in tr.export()}
    ev, sp = events["range2"], spans["span2"]
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    assert sp["t0"] * 1e9 <= start + 1e4 and start - sp["t0"] * 1e9 < 5e5
    assert end <= sp["t1"] * 1e9 + 1e4 and sp["t1"] * 1e9 - end < 5e5


def test_spans_nest_per_thread():
    tr = obs_trace.configure(enabled=True)
    seen = {}

    def other():
        with tr.span("other") as sp:
            seen["parent"] = sp.parent

    with tr.span("main") as outer:
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with tr.span("inner") as inner:
            assert inner.parent == outer.id
    assert seen["parent"] == 0 and tr.current() == (0, 0)
    tid = {s["name"]: s["tid"] for s in tr.export()}
    assert tid["other"] != tid["main"] == tid["inner"]


def test_ring_takes_spans_from_many_threads():
    """More threads than cores, switching every microsecond: every span
    lands in the ring once, under its own id."""
    tr = obs_trace.configure(enabled=True, capacity=1 << 16)
    threads, each = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with tr.span("a"):
                    tr.instant("b")
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    spans = tr.export()
    assert len(spans) == 2 * threads * each
    assert len({s["span"] for s in spans}) == len(spans)


# -- the LM paths --------------------------------------------------------

def _cfg(arch: str):
    return dataclasses.replace(
        reduced(get_config(arch), layers_per_segment=LAYERS), remat=True)


def _tokens(cfg, shape, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, shape, generator=gen)


def _kind(arch: str) -> str:
    return "ssm" if arch.startswith("mamba") else "attention"


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_spans(arch):
    """One ``train.step`` holding ``train.backward`` and
    ``train.optimizer``; a ``layer.mixer`` for every layer in the
    forward and one more in the backward's remat recompute."""
    cfg = _cfg(arch)
    state = init_train_state(cfg, torch.Generator().manual_seed(0))
    step = make_train_step(cfg)
    _profiled(lambda: step(state, {"tokens": _tokens(cfg, (2, 16))}))
    spans = obs_trace.get_tracer().export()
    by = _by_name(spans)
    (root,) = by["train.step"]
    (back,) = by["train.backward"]
    (opt,) = by["train.optimizer"]
    assert back["parent"] == opt["parent"] == root["span"]
    assert _inside(back, root) and _inside(opt, root)
    assert back["t1"] <= opt["t0"]
    mixers = by["layer.mixer"]
    assert {m["args"]["kind"] for m in mixers} == {_kind(arch)}
    forward = [m for m in mixers if m["t1"] <= back["t0"]]
    recompute = [m for m in mixers if _inside(m, back)]
    assert len(forward) == len(recompute) == LAYERS == len(mixers) // 2
    assert all(_inside(m, root) for m in forward)
    assert not any("device" in s for s in spans)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_spans(arch):
    cfg = _cfg(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prefill = make_prefill_step(cfg)
    with torch.inference_mode():
        _profiled(lambda: prefill(params, {"tokens": _tokens(cfg, (2, 16))}))
    by = _by_name(obs_trace.get_tracer().export())
    (root,) = by["prefill.step"]
    (head,) = by["model.head"]
    assert head["parent"] == root["span"] and _inside(head, root)
    assert len(by["layer.mixer"]) == LAYERS
    assert all(m["parent"] == root["span"] and m["t1"] <= head["t0"]
               for m in by["layer.mixer"])


def _serve(cfg, params, steps: int) -> np.ndarray:
    drv = ServeDriver(cfg=cfg, params=params, batch=2, max_len=16,
                      device="cpu")
    with torch.no_grad():
        return drv.generate(_tokens(cfg, (2, 1), seed=1), steps)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_spans_and_tokens(arch):
    """Each ``decode.step`` holds its ``decode.dispatch`` (the layers'
    mixers and the head inside it) and then its ``decode.readback``; the
    tokens served with the tracer following the profiler are those
    served with it forced off."""
    cfg, steps = _cfg(arch), 3
    params = init_params(cfg, torch.Generator().manual_seed(0))
    traced, _ = _profiled(lambda: _serve(cfg, params, steps))
    by = _by_name(obs_trace.get_tracer().export())
    assert len(by["decode.step"]) == len(by["decode.dispatch"]) \
        == len(by["decode.readback"]) == len(by["model.head"]) == steps
    assert len(by["layer.mixer"]) == LAYERS * steps
    for root, disp, back, head in zip(by["decode.step"], by["decode.dispatch"],
                                      by["decode.readback"], by["model.head"]):
        assert disp["parent"] == back["parent"] == root["span"]
        assert _inside(disp, root) and _inside(back, root)
        assert disp["t1"] <= back["t0"]
        assert head["parent"] == disp["span"] and _inside(head, disp)
    obs_trace.configure(enabled=False)
    plain, _ = _profiled(lambda: _serve(cfg, params, steps))
    assert obs_trace.get_tracer().export() == []
    np.testing.assert_array_equal(traced, plain)


class _Scalar:
    """A stand-in for a device scalar: counts its reads."""

    def __init__(self, value):
        self.value, self.reads = value, 0

    def item(self):
        self.reads += 1
        return self.value


def test_device_scalar_attribute_read_at_export_not_before():
    """``span.set`` keeps a tensor as it is; ``export()`` reads it once,
    and a later export gives the number without reading again."""
    tr = obs_trace.configure(enabled=True)
    rows = _Scalar(7)
    with tr.span("layer.moe") as sp:
        sp.set(held_rows=rows, kind="moe")
    with tr.span("after"):
        pass
    assert rows.reads == 0
    first = tr.export()
    assert rows.reads == 1
    assert first[0]["args"] == {"held_rows": 7, "kind": "moe"}
    assert tr.export()[0]["args"]["held_rows"] == 7 and rows.reads == 1
    with torch.no_grad():
        with tr.span("layer.moe") as sp:
            sp.set(max_rows=torch.tensor([3, 9]).max())
    assert tr.export()[-1]["args"] == {"max_rows": 9}
