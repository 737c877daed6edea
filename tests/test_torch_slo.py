"""The port's closed-loop SLO harness (``repro_torch.launch.slo``) on the
CPU: the ``SLOHarness`` cases of ``tests/test_slo_harness.py`` with
``device="cpu"`` (the reference's ``slow`` class stays ``slow``), and
the harness's numbers against the reference's under a ``ManualClock``.

Under a ``ManualClock`` every admission count, queueing latency,
staleness, cache counter and throughput of a run point is a function of
the seeded traffic and the simulated clock alone, so the port's
``run_point`` must return the reference's dict exactly. The trained
model's numbers come through autograd on one side and ``jax.grad`` on
the other, so the training metrics are held within ``TOL`` (as in
``tests/test_torch_cluster.py``)."""

import numpy as np
import pytest

from repro.core.monitor import ManualClock as RefClock
from repro.launch.slo import SLOConfig as RefConfig
from repro.launch.slo import SLOHarness as RefHarness
from repro_torch.core.monitor import ManualClock
from repro_torch.launch.slo import SLOConfig, SLOHarness

TOL = dict(rtol=1e-5, atol=1e-6)
SMALL = dict(rows=1 << 10, fields=4, req_batch=16, budget=64,
             train_events=32, warmup_ticks=2, measure_ticks=6,
             num_master=1, num_slave=1, num_replicas=1, lr_head=False,
             feedback_delay=0.2, join_window=1.0, seed=3)


def _harness(max_pending, **kw):
    clk = ManualClock()
    cfg = SLOConfig(**dict(SMALL, max_pending=max_pending, **kw),
                    device="cpu")
    return SLOHarness(cfg, clock=clk, tick_dt=1.0), clk


def _pair(**kw):
    """The port's harness and the reference's, same config, each on its
    own ManualClock."""
    cfg = dict(SMALL, **kw)
    ours = SLOHarness(SLOConfig(**cfg, device="cpu"), clock=ManualClock(),
                      tick_dt=1.0)
    ref = RefHarness(RefConfig(**cfg), clock=RefClock(), tick_dt=1.0)
    return ours, ref


# ---------------------------------------------------------------------------
# tests/test_slo_harness.py's TestClosedLoopOverload, on the port
# ---------------------------------------------------------------------------
@pytest.mark.slow
class TestClosedLoopOverload:
    def test_p50_unaffected_at_half_load(self):
        h, _ = _harness(max_pending=128)
        pt = h.run_point(0.5)
        assert pt["latency_s"]["p50"] == pytest.approx(0.0)
        assert pt["admission"]["shed_examples"] == 0
        assert pt["admission"]["executed_examples"] \
            == pt["admission"]["offered_examples"]

    def test_p99_bounded_under_2x_overload(self):
        h, _ = _harness(max_pending=128)
        pt = h.run_point(2.0)
        assert pt["admission"]["shed_examples"] > 0
        assert pt["latency_s"]["p99"] <= 3.0
        assert pt["pending_examples"] <= 128

    def test_unbounded_queue_without_admission(self):
        h, _ = _harness(max_pending=None)
        pt = h.run_point(2.0)
        assert pt["admission"]["shed_examples"] == 0
        assert pt["pending_examples"] >= 64 * 6
        assert pt["latency_s"]["p99"] > 3.0


# ---------------------------------------------------------------------------
# the port's harness against the reference's (tier-1)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("multiplier,max_pending,deadline", [
    (0.5, 128, None), (1.0, 128, None), (2.0, 128, None),
    (2.0, None, None), (4.0, 96, 2.5)])
def test_run_point_equals_reference(multiplier, max_pending, deadline):
    ours, ref = _pair(max_pending=max_pending, deadline=deadline)
    got, want = ours.run_point(multiplier), ref.run_point(multiplier)
    assert got == want
    assert ours.train_batches == ref.train_batches


def test_sweep_with_lr_head_equals_reference():
    """Two scenarios (the FM store and an LR head sharing its ``w``
    group) on 2 masters and 2 slave shards x 2 replicas, swept over the
    reference's default multipliers."""
    ours, ref = _pair(lr_head=True, num_master=2, num_slave=2,
                      num_replicas=2, max_pending=256, measure_ticks=4)
    got = ours.sweep((0.5, 1.0, 2.0, 4.0))
    want = ref.sweep((0.5, 1.0, 2.0, 4.0))
    assert got == want
    assert ours.serve_names == ref.serve_names
    assert [n for n, _ in ours.train_pipes] == \
        [n for n, _ in ref.train_pipes]


def test_metrics_equal_reference():
    ours, ref = _pair(max_pending=128)
    for h in (ours, ref):
        h.run_point(2.0)
    got, want = ours.metrics(), ref.metrics()
    assert got["train_batches"] == want["train_batches"] > 0
    assert got["train_examples"] == want["train_examples"] > 0
    assert got["serving"]["admission"] == want["serving"]["admission"]
    assert got["staleness"] == want["staleness"]
    assert sorted(got) == sorted(want)
    for name, scn in want["training"]["scenarios"].items():
        g = got["training"]["scenarios"][name]
        assert g["examples"] == scn["examples"]
        np.testing.assert_allclose(g["logloss"], scn["logloss"], **TOL)


def test_preseed_rows_and_requests_per_tick():
    h, _ = _harness(max_pending=128)
    assert h.requests_per_tick(0.5) == 2
    assert h.requests_per_tick(2.0) == 8
    assert h.requests_per_tick(1e-6) == 1
    ids = np.arange(SMALL["rows"], dtype=np.int64)
    for rs in h.cluster.replica_sets:
        for shard in rs.replicas:
            for g, t in shard.tables.items():
                assert len(t) == SMALL["rows"], g
                np.testing.assert_array_equal(np.sort(t.all_ids()), ids)
    assert str(h.cluster.device) == "cpu"


def test_export_trace_counts_spans(tmp_path):
    from repro_torch.obs import trace as obs_trace
    h, _ = _harness(max_pending=128)
    assert h.export_trace(str(tmp_path / "off.json")) == 0
    obs_trace.configure(enabled=True, process="slo")
    try:
        h.tick(1.0)
        assert h.export_trace(str(tmp_path / "on.json")) > 0
    finally:
        obs_trace.disable()
