"""Synthetic data streams — the port's copy of the reference's
``data/streams.py`` ``lm_batches`` (NumPy only, so the same seed gives
the same tokens in both packages).

The click stream and the sample joiner (``ClickStream``, ``EventBatch``,
``data/joiner.py``) are not ported yet.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


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
