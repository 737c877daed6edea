from repro_torch.serving.cache import DenseCache, ServeCache
from repro_torch.serving.plane import ServingPlane
from repro_torch.serving.registry import Scenario, ScenarioRegistry
from repro_torch.serving.router import RowRouter
from repro_torch.serving.scheduler import DEFAULT_BUCKETS, PredictScheduler

__all__ = [
    "DEFAULT_BUCKETS", "DenseCache", "PredictScheduler", "RowRouter",
    "Scenario", "ScenarioRegistry", "ServeCache", "ServingPlane",
]
