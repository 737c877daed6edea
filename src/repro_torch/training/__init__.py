"""The training plane of the port: per-scenario train steps over master
shards (``TrainingPlane``) and its scenario registry."""

from repro_torch.training.plane import TrainingPlane
from repro_torch.training.registry import (TrainRegistry, TrainScenario,
                                           TrainStats)

__all__ = ["TrainingPlane", "TrainRegistry", "TrainScenario", "TrainStats"]
