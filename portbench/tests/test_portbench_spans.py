"""The readers of the program's spans on made-up device records and
spans: idle time split into inside and outside the program (and by the
innermost span), a device interval clipped to the busy union, host
means of the decode step's parts, and None from every reader where the
slice holds none of its spans."""

from types import SimpleNamespace

import pytest

from portbench import harness, spans
from portbench.trace import Trace

MS = 1_000_000      # ns
NEW = ["dispatch_ms.decode", "readback_wait_ms.decode",
       "idle_in_program_pct.train", "idle_in_program_pct.prefill",
       "idle_in_program_pct.decode", "optimizer_pct.train",
       "backward_pct.train", "mixer_pct.train", "mixer_pct.prefill",
       "head_pct.prefill"]


def _span(name, host, device=None, **args):
    """A span as the tracer exports it; times in ms."""
    d = {"name": name, "t0": host[0] * 1e-3, "t1": host[1] * 1e-3,
         "proc": "main", "trace": 0, "span": 0, "parent": 0, "tid": 1}
    if device:
        d["device"] = (device[0] * 1e-3, device[1] * 1e-3)
    if args:
        d["args"] = args
    return d


# busy 0-4, 6-9, 12-13 ms of a 15 ms slice
OPS = [(0, 3 * MS, "gemm", True), (2 * MS, 4 * MS, "gemm", True),
       (6 * MS, 9 * MS, "flash", True), (12 * MS, 13 * MS, "Memcpy DtoH",
                                         False)]
TRAIN = [_span("train.step", (1, 12), (0, 13)),
         _span("layer.mixer", (2, 3), (3, 7), kind="attention"),
         _span("train.backward", (4, 9), (7, 12)),
         _span("train.optimizer", (10, 11), (11.5, 13))]


class _Tracer:
    def __init__(self, exported):
        self.exported = exported

    def export(self):
        return list(self.exported)


@pytest.fixture
def program(monkeypatch):
    """Install made-up exports as the program tracer's."""
    from repro_torch.obs import trace as obs_trace

    def install(exported):
        monkeypatch.setattr(obs_trace, "get_tracer",
                            lambda: _Tracer(exported))
    return install


def _cell(kind, **kw):
    return SimpleNamespace(kind=kind, trace=Trace(OPS, window_s=0.015),
                           trace_steps=2, **kw)


def test_idle_splits_into_inside_and_outside_the_program(program, capsys):
    """Idle 7 of 15 ms; inside the program's spans 4-6 (the backward
    innermost), 9-10 and 11-12 (the step), 10-11 (the optimizer); the
    other 2 ms outside it."""
    program(TRAIN)
    cell = _cell("train")
    inside, by = spans.idle_by_span(cell)
    assert inside == pytest.approx(0.005)
    assert by == pytest.approx({"train.backward": 0.002,
                                "train.step": 0.002,
                                "train.optimizer": 0.001})
    got = harness.metric_reader("idle_in_program_pct.train")(cell)
    assert got == pytest.approx(100 * 5 / 15)
    idle = harness.metric_reader("idle_pct.train")(cell)
    assert got <= idle == pytest.approx(100 * 7 / 15)
    err = capsys.readouterr().err
    assert "idle in train.backward 0.0020 s" in err
    assert f"idle {spans.OUTSIDE} 0.0020 s" in err
    assert "busy inside train.step 0.0080 s of the slice's 0.0080 s" in err


def test_device_interval_is_clipped_to_the_busy_union(program):
    """The mixer's device interval 3-7 ms holds 2 ms of busy time (3-4,
    6-7), the backward's 7-12 ms 2 (7-9), the optimizer's 11.5-13 ms 1
    (12-13), of the step's 8."""
    program(TRAIN)
    cell = _cell("train")
    assert spans.busy_inside(cell, [(0.003, 0.007)]) == pytest.approx(0.002)
    assert spans.busy_inside(cell, [(0.003, 0.007), (0.0035, 0.0065)]) \
        == pytest.approx(0.002)                     # overlap counted once
    for name, want in [("mixer_pct.train", 25.0), ("backward_pct.train", 25.0),
                       ("optimizer_pct.train", 12.5)]:
        assert harness.metric_reader(name)(cell) == pytest.approx(want)


def test_prefill_head_share(program):
    program([_span("prefill.step", (0, 13), (0, 13)),
             _span("layer.mixer", (1, 2), (0, 4), kind="attention"),
             _span("model.head", (8, 9), (8.5, 12.5))])
    cell = _cell("prefill")
    assert harness.metric_reader("head_pct.prefill")(cell) \
        == pytest.approx(100 * 1 / 8)               # 8.5-9, 12-12.5
    assert harness.metric_reader("mixer_pct.prefill")(cell) \
        == pytest.approx(100 * 4 / 8)


def test_decode_step_parts_are_host_means():
    """Through the port's own tracer, turned on: each part's mean host
    duration a step of the slice (a span an hour before it left out)."""
    from repro_torch.obs import trace as obs_trace
    tr = obs_trace.configure(enabled=True)
    try:
        tr.record("decode.dispatch", t0=-3600.0, t1=-3599.9)
        for t, (d, w) in enumerate([(2.0, 1.0), (4.0, 3.0)]):
            t0 = 0.001 + t * 0.005                  # 1-4 ms, 6-13 ms
            tr.record("decode.step", t0=t0, t1=t0 + (d + w) * 1e-3)
            tr.record("decode.dispatch", t0=t0, t1=t0 + d * 1e-3)
            tr.record("decode.readback", t0=t0 + d * 1e-3,
                      t1=t0 + (d + w) * 1e-3)
        cell = _cell("decode")
        assert harness.metric_reader("dispatch_ms.decode")(cell) \
            == pytest.approx(3.0)
        assert harness.metric_reader("readback_wait_ms.decode")(cell) \
            == pytest.approx(2.0)
    finally:
        obs_trace.disable()


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("exported", ["none", "others"])
def test_reader_without_its_spans_reads_nothing(program, name, exported):
    """No spans at all (a program whose tracer does not follow the
    profiler), or only spans of another kind of cell (no step span of
    the cell's kind): None. Without a trace: None."""
    program([] if exported == "none" else
            [_span("serve.flush", (0, 1)), _span("cache.invalidate", (1, 2))])
    kind = name.rpartition(".")[2]
    read = harness.metric_reader(name)
    assert read(_cell(kind)) is None
    assert read(SimpleNamespace(kind=kind, trace=None)) is None


def test_new_entries_name_their_readers():
    manifest = harness.load_manifest()
    names = [m["name"] for m in manifest["per_layer"]]
    assert names[-len(NEW):] == NEW
