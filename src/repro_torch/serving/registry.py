"""Multi-scenario serving registry.

One WeiPS cluster stores a shared sparse parameter space; many *serving
scenarios* (model variants — an LR head, the full FM, a DNN reading the
same embeddings) predict off subsets of it concurrently, each with its
own predict fn, micro-batching scheduler, cache namespace, and
metrics — the EasyRec-style many-scenarios-one-store layout the ROADMAP
names. Scenario membership is also published to the coordination
registry (``core.scheduler``) so predictors can discover it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.configs.weips_ctr import CTRConfig
from repro_torch.serving.cache import DenseCache, ServeCache
from repro_torch.serving.scheduler import PredictScheduler


@dataclass
class Scenario:
    """Everything one serving scenario owns: config, group subset, predict
    fn, cache namespaces, scheduler, counters."""

    name: str
    cfg: CTRConfig
    groups: dict[str, int]                    # subset of the store groups
    dense_shapes: dict[str, tuple]
    predict_raw: Callable                     # (rows, dense) -> (B,)
    predict_block: Callable                   # (block, dense) -> (B,)
    cache: ServeCache
    dense_cache: DenseCache = field(default_factory=DenseCache)
    scheduler: Optional[PredictScheduler] = None
    requests: int = 0
    examples: int = 0

    def metrics(self) -> dict:
        out = {"requests": self.requests, "examples": self.examples,
               "cache": self.cache.stats(),
               "dense_cache": self.dense_cache.stats(),
               "dense_refreshes": self.dense_cache.refreshes}
        if self.scheduler is not None:
            s = self.scheduler.stats
            out["batches"] = s.batches
            out["padding_fraction"] = s.padding_fraction
            out["admission"] = self.scheduler.adm.as_dict()
            out["latency"] = self.scheduler.latency.percentiles((50, 99))
        return out

    def window_metrics(self) -> dict:
        """Per-window cache counter deltas (resets the window marks)."""
        return {"cache": self.cache.window_stats(),
                "dense_cache": self.dense_cache.window_stats()}


class ScenarioRegistry:
    """Named scenarios; the first one added is the default."""

    def __init__(self):
        self._scenarios: dict[str, Scenario] = {}
        self._default: Optional[str] = None

    def add(self, scenario: Scenario) -> Scenario:
        if scenario.name in self._scenarios:
            raise ValueError(f"scenario {scenario.name!r} already exists")
        self._scenarios[scenario.name] = scenario
        if self._default is None:
            self._default = scenario.name
        return scenario

    def get(self, name: Optional[str] = None) -> Scenario:
        key = self._default if name is None else name
        if key is None or key not in self._scenarios:
            raise KeyError(f"unknown scenario {name!r} "
                           f"(have: {sorted(self._scenarios)})")
        return self._scenarios[key]

    def register_metrics(self, reg, prefix: str = "scenarios") -> None:
        """Publish every scenario's ``metrics()`` dict under
        ``<prefix>.<scenario-name>`` in a
        ``repro_torch.obs.metrics.MetricsRegistry``. Registered as ONE
        provider so scenarios added later still show up."""
        reg.register(prefix,
                     lambda: {s.name: s.metrics() for s in self})

    def names(self) -> list[str]:
        return sorted(self._scenarios)

    def __iter__(self):
        return iter(self._scenarios.values())

    def __len__(self) -> int:
        return len(self._scenarios)
