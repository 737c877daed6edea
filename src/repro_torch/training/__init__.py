"""The training plane of the port: per-scenario train steps over master
shards (``TrainingPlane``) and its scenario registry, the online ingest
pipeline (``TrainPipeline``) and its round-robin driver
(``TrainScheduler``), and LM training (``TrainState``,
``make_train_step``)."""

from repro_torch.training.pipeline import TRAIN_BUCKETS, TrainPipeline
from repro_torch.training.plane import TrainingPlane
from repro_torch.training.registry import (TrainRegistry, TrainScenario,
                                           TrainStats)
from repro_torch.training.scheduler import TrainScheduler
from repro_torch.training.trainer import (TrainState, init_train_state,
                                          loss_and_grads, loss_fn,
                                          make_train_step)

__all__ = ["TRAIN_BUCKETS", "TrainPipeline", "TrainScheduler", "TrainState",
           "TrainingPlane", "TrainRegistry", "TrainScenario", "TrainStats",
           "init_train_state", "loss_and_grads", "loss_fn",
           "make_train_step"]
