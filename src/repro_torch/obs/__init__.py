"""Observability: span tracer (``obs.trace``, following ``torch.profiler``
on its clock, with device intervals), metrics registry (``obs.metrics``)
and Chrome/Perfetto trace export (``obs.perfetto``). The registry and
the export are pure stdlib, copied from the reference package."""

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer, configure, disable, get_tracer

__all__ = ["MetricsRegistry", "Tracer", "configure", "disable", "get_tracer"]
