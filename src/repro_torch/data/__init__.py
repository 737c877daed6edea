"""Data streams of the port: the click stream and its sample joiner
(the online-learning path's ingest) and ``lm_batches``."""

from repro_torch.data.joiner import (ExposureEvent, FeedbackEvent,
                                     JoinedBatch, JoinedSample, SampleJoiner)
from repro_torch.data.streams import ClickStream, EventBatch, lm_batches

__all__ = ["ExposureEvent", "FeedbackEvent", "JoinedBatch", "JoinedSample",
           "SampleJoiner", "ClickStream", "EventBatch", "lm_batches"]
