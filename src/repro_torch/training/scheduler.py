"""TrainScheduler (counterpart of the reference's
``training/scheduler.py``): drives N scenario pipelines concurrently off
the shared PS — the training twin of the serving plane's per-scenario
PredictSchedulers, but time-multiplexed (one process simulates the
cluster): each ``tick`` rotates through the registered pipelines in
round-robin order so no scenario starves, and every pipeline applies its
own backpressure bound before pushing updates. Scenario membership is
published through the core coordination ``Scheduler``
(``register_train_scenario``) by the cluster, exactly like serving
scenarios are.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.training.pipeline import TrainPipeline
from repro_torch.training.plane import TrainingPlane


class TrainScheduler:
    """Round-robin driver over every scenario pipeline of a plane."""

    def __init__(self, plane: TrainingPlane):
        self.plane = plane
        self._rr = 0
        self.ticks = 0

    def pipelines(self) -> list[TrainPipeline]:
        return [s.pipeline for s in self.plane.registry
                if s.pipeline is not None]

    def pipeline(self, name: Optional[str] = None) -> TrainPipeline:
        p = self.plane.registry.get(name).pipeline
        if p is None:
            raise KeyError(f"scenario {name!r} has no pipeline attached")
        return p

    def tick(self, now: float, *, flush: bool = False) -> dict[str, list]:
        """Advance every pipeline once, rotating the start position so
        concurrent scenarios share the process fairly."""
        pipes = self.pipelines()
        if not pipes:
            return {}
        self._rr = (self._rr + 1) % len(pipes)
        order = pipes[self._rr:] + pipes[:self._rr]
        self.ticks += 1
        return {p.scn.name: p.tick(now, flush=flush) for p in order}

    def flush(self, now: float) -> dict[str, list]:
        return self.tick(now, flush=True)

    def metrics(self) -> dict:
        return {p.scn.name: p.metrics() for p in self.pipelines()}
