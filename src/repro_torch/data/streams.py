"""Synthetic stream generators — counterpart of the reference's
``data/streams.py`` (NumPy only, so the same seed gives the same events
and tokens in both packages).

ClickStream drives the online-learning path: Zipfian feature ids (the
skew behind the paper's >=90 % update-repetition observation), a drifting
logistic ground truth (so domino-downgrade triggers are testable by
injecting distribution shifts), and exposure->feedback delays for the
joiner. ``lm_batches`` packs token streams for LM training.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.data.joiner import ExposureEvent, FeedbackEvent


@dataclass
class EventBatch:
    """One tick's worth of columnar stream events: every exposure at time
    ``t`` plus the (delayed) feedback rows its positives will produce —
    the unit ``TrainPipeline.ingest`` consumes."""

    t: float
    view_ids: np.ndarray       # (n,) int64
    feature_ids: np.ndarray    # (n, F) int64
    labels: np.ndarray         # (n,) ground-truth labels (for evaluation)
    fb_view_ids: np.ndarray    # (k,) positives' view ids
    fb_t: np.ndarray           # (k,) feedback arrival times

    def __len__(self) -> int:
        return len(self.view_ids)


@dataclass
class ClickStream:
    feature_space: int = 1 << 16
    fields: int = 16
    zipf_a: float = 1.3
    feedback_delay: float = 5.0
    drift_scale: float = 0.0          # ground-truth drift per emitted batch
    signal_scale: float = 0.4         # |true_w| magnitude (task separability)
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        self._true_w = self.rng.normal(
            size=self.feature_space) * self.signal_scale
        self._view = 0

    def corrupt(self, scale: float = 3.0) -> None:
        """Adversarial distribution shift: the ground truth flips sign (and
        sharpens), so everything the model has learned predicts confidently
        *wrong* — the metric collapse the domino downgrade must catch."""
        self._true_w = -self._true_w * scale

    def features(self, n: int) -> np.ndarray:
        ids = self.rng.zipf(self.zipf_a, size=(n, self.fields))
        return (ids % self.feature_space).astype(np.int64)

    def labels(self, ids: np.ndarray) -> np.ndarray:
        logits = self._true_w[ids].sum(axis=1)
        return (self.rng.random(len(ids)) <
                1.0 / (1.0 + np.exp(-logits))).astype(np.float32)

    def batch(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        if self.drift_scale:
            self._true_w += self.rng.normal(
                size=self.feature_space) * self.drift_scale
        ids = self.features(n)
        return ids, self.labels(ids)

    def events_batch(self, n: int, t: float) -> "EventBatch":
        """Columnar exposure + feedback events at time ``t`` — the
        vectorized joiner's native input (``SampleJoiner.offer_exposures``
        / ``offer_feedbacks``). Feedback rows exist only for positives,
        delayed by an exponential draw (the exposure→feedback gap the
        join window must cover)."""
        ids, y = self.batch(n)
        vids = np.arange(self._view, self._view + n, dtype=np.int64)
        self._view += n
        pos = np.flatnonzero(y > 0)
        delays = self.rng.exponential(self.feedback_delay, size=len(pos))
        return EventBatch(t=t, view_ids=vids, feature_ids=ids, labels=y,
                          fb_view_ids=vids[pos], fb_t=t + delays)

    def events(self, n: int, t: float) -> tuple[list[ExposureEvent],
                                                list[FeedbackEvent]]:
        """Per-event view of ``events_batch`` (legacy object API)."""
        b = self.events_batch(n, t)
        exposures = [ExposureEvent(t=t, view_id=int(v),
                                   feature_ids=tuple(f.tolist()))
                     for v, f in zip(b.view_ids, b.feature_ids)]
        feedbacks = [FeedbackEvent(t=float(ft), view_id=int(v))
                     for v, ft in zip(b.fb_view_ids, b.fb_t)]
        return exposures, feedbacks


def lm_batches(vocab_size: int, batch: int, seq_len: int, *,
               seed: int = 0, structured: bool = True) -> Iterator[np.ndarray]:
    """Endless packed token batches, (batch, seq_len) int32. ``structured``
    mixes a Markov-ish bigram pattern into the stream so training loss
    visibly decreases."""
    rng = np.random.default_rng(seed)
    if structured:
        # sparse bigram table: each token has a few likely successors
        succ = rng.integers(0, vocab_size, size=(vocab_size, 4))
    while True:
        if structured:
            out = np.empty((batch, seq_len), dtype=np.int32)
            tok = rng.integers(0, vocab_size, size=batch)
            for t in range(seq_len):
                out[:, t] = tok
                follow = succ[tok, rng.integers(0, 4, size=batch)]
                rand = rng.integers(0, vocab_size, size=batch)
                use_follow = rng.random(batch) < 0.8
                tok = np.where(use_follow, follow, rand)
            yield out
        else:
            yield rng.integers(0, vocab_size, size=(batch, seq_len),
                               dtype=np.int32)
