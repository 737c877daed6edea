"""Scheduler (paper §3.3): stateless lifecycle + metadata management —
counterpart of the reference's ``core/scheduler.py``.

All durable state lives in the coordination registry (stand-in for
ZooKeeper/etcd): shard membership, routing plan, version registry, consumer
offsets. The scheduler object itself can be dropped and rebuilt from the
registry — mirroring the paper's "the scheduler component ... is stateless".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


class CoordinationRegistry:
    """ZooKeeper/etcd stand-in: versioned key-value store with CAS."""

    def __init__(self):
        self._data: dict[str, tuple[int, Any]] = {}

    def put(self, key: str, value: Any) -> int:
        ver = self._data.get(key, (0, None))[0] + 1
        self._data[key] = (ver, value)
        return ver

    def get(self, key: str, default=None) -> Any:
        return self._data.get(key, (0, default))[1]

    def cas(self, key: str, expected_version: int, value: Any) -> bool:
        cur = self._data.get(key, (0, None))[0]
        if cur != expected_version:
            return False
        self._data[key] = (cur + 1, value)
        return True

    def version(self, key: str) -> int:
        return self._data.get(key, (0, None))[0]

    def keys(self, prefix: str = "") -> list[str]:
        return sorted(k for k in self._data if k.startswith(prefix))


@dataclass
class ComponentInfo:
    role: str                  # trainer | predictor | master | slave
    shard_id: int
    replica_id: int = 0
    alive: bool = True
    started_at: float = 0.0


class Scheduler:
    """Lifecycle + metadata for the whole cluster."""

    def __init__(self, registry: Optional[CoordinationRegistry] = None):
        self.registry = registry or CoordinationRegistry()

    # -- membership ---------------------------------------------------------
    def register(self, info: ComponentInfo) -> str:
        key = f"members/{info.role}/{info.shard_id}/{info.replica_id}"
        self.registry.put(key, info)
        return key

    def mark_dead(self, role: str, shard_id: int, replica_id: int = 0):
        key = f"members/{role}/{shard_id}/{replica_id}"
        info = self.registry.get(key)
        if info is not None:
            info.alive = False
            self.registry.put(key, info)

    def members(self, role: str) -> list[ComponentInfo]:
        return [self.registry.get(k)
                for k in self.registry.keys(f"members/{role}/")]

    # -- model version metadata ----------------------------------------------
    def publish_version(self, model: str, version: int,
                        meta: Optional[dict] = None) -> None:
        self.registry.put(f"models/{model}/versions/{version}", meta or {})
        self.registry.put(f"models/{model}/current", version)

    def current_version(self, model: str) -> Optional[int]:
        return self.registry.get(f"models/{model}/current")

    def set_routing(self, model: str, plan) -> None:
        self.registry.put(f"models/{model}/routing", plan)

    def routing(self, model: str):
        return self.registry.get(f"models/{model}/routing")

    # -- serving scenarios ---------------------------------------------------
    def register_scenario(self, model: str, scenario: str,
                          meta: Optional[dict] = None) -> None:
        """Publish a serving scenario (a predict configuration reading a
        subset of the shared PS groups) into the registry — predictors
        discover scenario membership the same way shards discover
        routing, so the registry stays the single durable source."""
        self.registry.put(f"models/{model}/scenarios/{scenario}", meta or {})

    def scenarios(self, model: str) -> list[str]:
        prefix = f"models/{model}/scenarios/"
        return [k[len(prefix):] for k in self.registry.keys(prefix)]

    def scenario_meta(self, model: str, scenario: str) -> Optional[dict]:
        return self.registry.get(f"models/{model}/scenarios/{scenario}")

    # -- training scenarios --------------------------------------------------
    def register_train_scenario(self, model: str, scenario: str,
                                meta: Optional[dict] = None) -> None:
        """Publish a *training* scenario — the symmetric twin of
        ``register_scenario``: trainers discover which model variants are
        learning off the shared PS (and which groups they own) through
        the same durable registry predictors use."""
        self.registry.put(f"models/{model}/train_scenarios/{scenario}",
                          meta or {})

    def train_scenarios(self, model: str) -> list[str]:
        prefix = f"models/{model}/train_scenarios/"
        return [k[len(prefix):] for k in self.registry.keys(prefix)]

    def train_scenario_meta(self, model: str,
                            scenario: str) -> Optional[dict]:
        return self.registry.get(
            f"models/{model}/train_scenarios/{scenario}")
