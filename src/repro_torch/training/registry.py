"""Multi-scenario training registry — the symmetric twin of
``serving/registry.py``; counterpart of the reference's
``training/registry.py``.

One WeiPS cluster stores a shared sparse parameter space; many *training
scenarios* (model variants) learn off it concurrently, each with its own
weighted loss fn, dense head, progressive-validation evaluators,
step counter, and (optionally) ingest pipeline. A scenario either
*shares* store groups (an LR head refining the ``w`` matrix an FM store
also trains — the EasyRec-style layout) or owns *namespaced* groups
(``"<name>/w"``) created online on every master and slave shard, so its
parameters are isolated while still riding the shared routing plan,
sync stream and serving fabric.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.configs.weips_ctr import CTRConfig
from repro_torch.core.monitor import ProgressiveValidator, StreamingEvaluator


@dataclass
class TrainStats:
    batches: int = 0
    examples: int = 0
    padded_examples: int = 0        # zero-weight rows added to reach a bucket
    raw_ids: int = 0                # ids entering train steps (with repeats)
    unique_ids: int = 0             # ids after per-batch dedup/coalesce
    bucket_counts: dict = field(default_factory=dict)

    @property
    def dedup_ratio(self) -> float:
        """Fraction of per-batch id traffic absorbed by dedup/coalesce
        (the paper's ≥90 % update-repetition observation, measured)."""
        if self.raw_ids == 0:
            return 0.0
        return 1.0 - self.unique_ids / self.raw_ids

    @property
    def padding_fraction(self) -> float:
        total = self.examples + self.padded_examples
        return self.padded_examples / total if total else 0.0


@dataclass
class TrainScenario:
    """Everything one training scenario owns. ``group_map`` maps the
    model's group names (what the loss fn reads) to store group names
    (what the PS tables are called) — identity for shared scenarios,
    ``name/``-prefixed for isolated ones."""

    name: str
    cfg: CTRConfig
    group_map: dict[str, str]                 # model group -> store group
    groups: dict[str, int]                    # model group -> row dim
    predict: Callable                         # (rows, dense) -> (B,)
    loss_grads: Callable                      # (rows, dense, y, w)
    dense: dict[str, np.ndarray]              # model-named dense tensors
    dense_slots: dict[str, dict]              # optimizer slots, on device
    dense_prefix: str = ""                    # store-name prefix for dense
    validator: ProgressiveValidator = field(
        default_factory=ProgressiveValidator)
    evaluator: StreamingEvaluator = field(default_factory=StreamingEvaluator)
    pipeline: Optional[object] = None         # an ingest pipeline with metrics()
    step: int = 0
    stats: TrainStats = field(default_factory=TrainStats)

    @property
    def store_groups(self) -> dict[str, int]:
        return {self.group_map[g]: dim for g, dim in self.groups.items()}

    def dense_store_name(self, name: str) -> str:
        return self.dense_prefix + name

    def metrics(self) -> dict:
        out = {"step": self.step,
               "batches": self.stats.batches,
               "examples": self.stats.examples,
               "dedup_ratio": self.stats.dedup_ratio,
               "padding_fraction": self.stats.padding_fraction,
               "logloss": self.evaluator.smoothed("logloss"),
               "auc": self.evaluator.smoothed("auc"),
               "calibration": self.evaluator.smoothed("calibration")}
        if self.pipeline is not None:
            out["pipeline"] = self.pipeline.metrics()
        return out


class TrainRegistry:
    """Named training scenarios; the first one added is the default."""

    def __init__(self):
        self._scenarios: dict[str, TrainScenario] = {}
        self._default: Optional[str] = None

    def add(self, scenario: TrainScenario) -> TrainScenario:
        if scenario.name in self._scenarios:
            raise ValueError(
                f"train scenario {scenario.name!r} already exists")
        self._scenarios[scenario.name] = scenario
        if self._default is None:
            self._default = scenario.name
        return scenario

    def get(self, name: Optional[str] = None) -> TrainScenario:
        key = self._default if name is None else name
        if key is None or key not in self._scenarios:
            raise KeyError(f"unknown train scenario {name!r} "
                           f"(have: {sorted(self._scenarios)})")
        return self._scenarios[key]

    def names(self) -> list[str]:
        return sorted(self._scenarios)

    def __iter__(self):
        return iter(self._scenarios.values())

    def __len__(self) -> int:
        return len(self._scenarios)
