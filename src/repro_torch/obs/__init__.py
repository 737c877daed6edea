"""Observability: span tracer (``obs.trace``) and metrics registry
(``obs.metrics``), both pure stdlib, copied from the reference package."""

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import Tracer, configure, disable, get_tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Tracer", "configure", "disable", "get_tracer",
]
