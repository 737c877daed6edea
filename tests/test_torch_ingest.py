"""The port's ingest path against the JAX package's, on the CPU:
``ClickStream`` → ``SampleJoiner`` → ``TrainPipeline``.

* ``ClickStream`` from the same seed gives the same events (ids, labels,
  feedback rows and times), drift and corruption included.
* ``SampleJoiner`` emissions are equal, field for field and in order, to
  the reference joiner's on ``tests/test_join_props.py``'s seeded
  adversarial schedules, plain, with the emit-on-feedback fast path and
  with negative downsampling.
* ``TrainPipeline`` hands the training plane the same micro-batches (ids,
  labels, weights, bucket sizes, times), throttles and sheds the same
  samples and reports the same counters."""

from types import SimpleNamespace

import numpy as np
import pytest

from repro.data import ClickStream as RefStream
from repro.data import SampleJoiner as RefJoiner
from repro.training.pipeline import TrainPipeline as RefPipeline
from repro_torch.data import ClickStream, SampleJoiner
from repro_torch.training import TRAIN_BUCKETS, TrainPipeline
from test_join_props import random_schedule

BATCH_FIELDS = ("t_emit", "view_ids", "feature_ids", "labels",
                "join_delay", "weights")


def _same_batch(got, want):
    if want is None:
        assert got is None
        return
    assert len(got) == len(want)
    for f in BATCH_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("drift", [0.0, 0.05])
def test_click_stream_events_match_reference(drift):
    kw = dict(feature_space=1 << 12, fields=6, zipf_a=1.2,
              feedback_delay=1.0, drift_scale=drift, signal_scale=0.8,
              seed=3)
    port, ref = ClickStream(**kw), RefStream(**kw)
    for tick in range(6):
        if tick == 4:
            port.corrupt()
            ref.corrupt()
        a, b = port.events_batch(200, 0.2 * tick), \
            ref.events_batch(200, 0.2 * tick)
        assert a.t == b.t and len(a) == len(b) == 200
        for f in ("view_ids", "feature_ids", "labels", "fb_view_ids",
                  "fb_t"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=f)
    ids, y = port.batch(64)
    rids, ry = ref.batch(64)
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(y, ry)
    exp, fb = port.events(16, 3.0)
    rexp, rfb = ref.events(16, 3.0)
    assert [(e.t, e.view_id, e.feature_ids) for e in exp] == \
        [(e.t, e.view_id, e.feature_ids) for e in rexp]
    assert [(e.t, e.view_id, e.label) for e in fb] == \
        [(e.t, e.view_id, e.label) for e in rfb]


MODES = {"plain": {}, "fast": dict(emit_on_feedback=True),
         "downsample": dict(neg_sample_rate=0.5, seed=4)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("seed", range(8))
def test_joiner_matches_reference_on_schedules(mode, seed):
    rng = np.random.default_rng(seed)
    ops = random_schedule(rng)
    port = SampleJoiner(window=5.0, **MODES[mode])
    ref = RefJoiner(window=5.0, **MODES[mode])
    for op in ops:
        if op[0] == "expose":
            _, ts, vids, feats = op
            port.offer_exposures(ts, vids, feats)
            ref.offer_exposures(ts, vids, feats)
        elif op[0] == "feedback":
            _, t, vids = op
            _same_batch(port.offer_feedbacks(t, vids),
                        ref.offer_feedbacks(t, vids))
        else:
            _same_batch(port.drain_batch(op[1]), ref.drain_batch(op[1]))
        assert port.metrics() == ref.metrics()
    _same_batch(port.drain_batch(1e9), ref.drain_batch(1e9))
    assert port.metrics() == ref.metrics()
    assert port.emitted > 0


def test_joiner_per_event_api_and_errors():
    from repro.data.joiner import ExposureEvent as RefExp
    from repro.data.joiner import FeedbackEvent as RefFb
    from repro_torch.data.joiner import ExposureEvent, FeedbackEvent
    port, ref = SampleJoiner(window=2.0), RefJoiner(window=2.0)
    for i in range(5):
        port.offer_exposure(ExposureEvent(t=0.5 * i, view_id=i % 3,
                                          feature_ids=(i, i + 1)))
        ref.offer_exposure(RefExp(t=0.5 * i, view_id=i % 3,
                                  feature_ids=(i, i + 1)))
    port.offer_feedback(FeedbackEvent(t=1.0, view_id=1))
    ref.offer_feedback(RefFb(t=1.0, view_id=1))
    got, want = port.drain(10.0), ref.drain(10.0)
    assert [(s.t_emit, s.view_id, s.feature_ids.tolist(), s.label,
             s.join_delay, s.weight) for s in got] == \
        [(s.t_emit, s.view_id, s.feature_ids.tolist(), s.label,
          s.join_delay, s.weight) for s in want]
    with pytest.raises(ValueError):
        SampleJoiner(neg_sample_rate=0.0)
    with pytest.raises(ValueError):
        port.offer_exposures(0.0, np.array([9]), np.zeros((1, 3), np.int64))


class _Plane:
    """A training plane that records what the pipeline hands it."""

    def __init__(self):
        self.calls = []

    def train_batch(self, scn, ids, y, *, weights, now, bucket):
        self.calls.append((ids.copy(), y.copy(), weights.copy(), now,
                           bucket))
        return {"n": len(ids)}


@pytest.mark.parametrize("case", ["plain", "fast_throttled_shed"])
def test_pipeline_micro_batches_match_reference(case):
    fast = case != "plain"
    lag = {"v": 0}
    kw = dict(buckets=(128, 256, 512), buffer_cap=400 if fast else 1 << 16,
              max_sync_lag=5 if fast else None, lag_fn=lambda: lag["v"])
    sides = []
    for pipe_cls, joiner, stream in (
            (TrainPipeline, SampleJoiner, ClickStream),
            (RefPipeline, RefJoiner, RefStream)):
        plane = _Plane()
        scn = SimpleNamespace(name="s", pipeline=None)
        j = joiner(window=1.0, emit_on_feedback=fast,
                   neg_sample_rate=0.7 if fast else 1.0, seed=1)
        pipe = pipe_cls(plane, scn, j, **kw)
        assert scn.pipeline is pipe
        sides.append((plane, pipe, stream(feature_space=1 << 12, fields=5,
                                          feedback_delay=0.5, seed=2)))
    now = 0.0
    for tick in range(30):
        lag["v"] = 10 if fast and 8 <= tick < 14 else 0   # a throttle spell
        for plane, pipe, stream in sides:
            pipe.ingest(stream.events_batch(150, now))
            pipe.tick(now)
        now += 0.25
    for _, pipe, _ in sides:
        pipe.flush(now + 5.0)
    (pp, port, _), (rp, ref, _) = sides
    assert port.metrics() == ref.metrics()
    assert len(pp.calls) == len(rp.calls) > 10
    for a, b in zip(pp.calls, rp.calls):
        for x, y in zip(a[:3], b[:3]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert a[3:] == b[3:]
    if fast:
        assert port.throttled_ticks > 0 and port.shed_examples > 0
        assert port.joiner.fast_emits > 0
    assert port.bucket_for(129) == 256 and port.bucket_for(10_000) == 512
    assert TRAIN_BUCKETS == (128, 256, 512, 1024, 2048, 4096)
    with pytest.raises(ValueError):
        TrainPipeline(_Plane(), SimpleNamespace(), SampleJoiner(),
                      buckets=())
