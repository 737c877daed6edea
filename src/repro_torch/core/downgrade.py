"""Domino downgrade (paper §4.3.2): smoothed-threshold trigger + hot version
switch back to a stable checkpointed version, with queue-offset replay —
counterpart of the reference's ``core/downgrade.py``.

Any stored version qualifies as a switch target — full or delta: the
executor's ``switch_fn`` restores through the cold-backup chain
(``ColdBackup.materialize`` folds full+deltas into full-equivalent state)
and seeks the serving consumers to the checkpoint's queue offsets, so
streaming replay resumes exactly where the restored state left off.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.fault_tolerance import Checkpoint, CheckpointStore
from repro_torch.core.monitor import ProgressiveValidator


@dataclass
class SmoothedThresholdTrigger:
    """Fires when the *smoothed* metric crosses ``threshold``. Smoothing
    over ``window`` contrast points suppresses single-batch false alarms
    (§4.3.2a). ``direction`` = "above" (e.g. logloss) or "below" (auc)."""

    metric: str = "logloss"
    threshold: float = 1.0
    window: int = 10
    direction: str = "above"
    min_points: int = 5

    def check(self, validator: ProgressiveValidator) -> bool:
        if len(validator.history) < self.min_points:
            return False
        v = validator.smoothed(self.metric, self.window)
        return v > self.threshold if self.direction == "above" \
            else v < self.threshold


class VersionManager:
    """Registry of model versions = checkpoints + their metrics; supports
    the two switching strategies: latest-stable and best-metric (§4.3.2b)."""

    def __init__(self, store: CheckpointStore):
        self.store = store
        self.current_version: Optional[int] = None
        self.bad_versions: set[int] = set()

    def stable_versions(self) -> list[int]:
        return [v for v in self.store.versions() if v not in self.bad_versions]

    def pick(self, strategy: str = "latest",
             metric: str = "logloss", direction: str = "min") -> int:
        candidates = self.stable_versions()
        if not candidates:
            raise RuntimeError("no stable version to downgrade to")
        if strategy == "latest":
            return candidates[-1]
        if strategy == "best":
            def score(v):
                m = self.store.load(v).metrics.get(metric)
                if m is None:
                    return float("inf") if direction == "min" else -float("inf")
                return m
            return (min if direction == "min" else max)(candidates, key=score)
        raise ValueError(strategy)


class DominoDowngrade:
    """Trigger + execution. ``switch_fn(ckpt)`` performs the hot switch:
    reload slave state from the checkpoint (materializing its full+delta
    chain — see ``WeiPSCluster._hot_switch``) and seek scatters to the
    stored queue offsets so streaming resumes consistently."""

    def __init__(self, trigger: SmoothedThresholdTrigger,
                 versions: VersionManager,
                 switch_fn: Callable[[Checkpoint], None],
                 strategy: str = "latest", cooldown: float = 0.0):
        self.trigger = trigger
        self.versions = versions
        self.switch_fn = switch_fn
        self.strategy = strategy
        # refractory window after a switch: the smoothed trigger metric
        # still averages pre-switch contrast points for up to ``window``
        # batches, so without a cooldown one bad stretch cascades through
        # every stored version before the restored model gets a reading.
        self.cooldown = cooldown
        self.downgrades: list[tuple[float, int]] = []

    def active(self, now: float) -> bool:
        """True while the last downgrade's cooldown window is open — the
        "fired" state; it un-fires when the window closes without the
        trigger tripping again."""
        return bool(self.downgrades) and \
            (now - self.downgrades[-1][0]) < self.cooldown

    def maybe_downgrade(self, now: float,
                        validator: ProgressiveValidator) -> Optional[int]:
        if self.active(now):
            return None
        if not self.trigger.check(validator):
            return None
        return self.execute(now)

    def execute(self, now: float, version: Optional[int] = None) -> int:
        """Manual or automatic downgrade to ``version`` (or per strategy)."""
        cur = self.versions.current_version
        if cur is not None:
            self.versions.bad_versions.add(cur)
        v = version if version is not None else self.versions.pick(
            self.strategy)
        ckpt = self.versions.store.load(v)
        self.switch_fn(ckpt)
        self.versions.current_version = v
        self.downgrades.append((now, v))
        return v
