"""``graph_replay_pct.decode`` on made-up spans: every dispatch a replay,
a capture among replays, eager steps only, dispatch spans without the
``graph`` attribute (a program that does not capture), and a cell of
another kind."""

from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.trace import Trace

MS = 1_000_000      # ns
NAME = "graph_replay_pct.decode"


class _Tracer:
    def __init__(self, exported):
        self.exported = exported

    def export(self):
        return list(self.exported)


def _dispatches(*modes):
    """One ``decode.step`` a mode with its ``decode.dispatch`` (the
    ``graph`` attribute ``mode``, none for None), 1 ms apart."""
    out = []
    for i, mode in enumerate(modes):
        t0 = i * 1e-3
        out.append({"name": "decode.step", "t0": t0, "t1": t0 + 9e-4})
        d = {"name": "decode.dispatch", "t0": t0, "t1": t0 + 1e-4}
        if mode is not None:
            d["args"] = {"graph": mode}
        out.append(d)
    return out


def _cell(kind, exported, monkeypatch):
    from repro_torch.obs import trace as obs_trace
    monkeypatch.setattr(obs_trace, "get_tracer", lambda: _Tracer(exported))
    ops = [(0, 4 * MS, "decode_attention", True)]
    return SimpleNamespace(kind=kind, trace=Trace(ops, window_s=0.004),
                           trace_steps=4)


@pytest.mark.parametrize("modes,want", [
    (("replay",) * 4, 100.0),
    (("capture", "replay", "replay", "replay"), 75.0),
    (("eager", "capture", "replay", "replay"), 50.0),
    (("eager",) * 4, 0.0),
])
def test_share_of_replayed_dispatches(monkeypatch, modes, want):
    cell = _cell("decode", _dispatches(*modes), monkeypatch)
    assert harness.metric_reader(NAME)(cell) == pytest.approx(want)


def test_dispatch_without_the_attribute_reads_nothing(monkeypatch):
    cell = _cell("decode", _dispatches(None, None, None, None), monkeypatch)
    assert harness.metric_reader(NAME)(cell) is None


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_no_decode_cell_reads_nothing(monkeypatch, kind):
    cell = _cell(kind, _dispatches(*("replay",) * 4), monkeypatch)
    assert harness.metric_reader(NAME)(cell) is None
    assert harness.metric_reader(NAME)(SimpleNamespace(kind="decode",
                                                       trace=None)) is None


def test_manifest_names_the_reader():
    entry = harness.entry(harness.load_manifest()["per_layer"], NAME)
    assert entry["workloads"] == ["qwen2-1.5b.decode"]
    assert entry["moves"] == "tpot_p95_ms"
