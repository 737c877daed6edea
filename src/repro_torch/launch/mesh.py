"""Process placement for the multi-process cluster runtime
(``launch/runtime.py``): the process half of the reference's
``launch/mesh.py``. The device meshes and the TPU constants of its other
half are not ported yet.

Every worker process of a grid shares the one card through the explicit
device index in ``RuntimeConfig.device``; the grid here is of processes,
not devices."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ProcSlot:
    """One logical position in the process grid: a master shard or one
    replica of a slave shard. ``replica`` is None for masters (masters are
    cold-backed by checkpoints, not replicated)."""

    role: str                 # "master" | "slave"
    shard_id: int
    replica: Optional[int] = None

    @property
    def name(self) -> str:
        if self.role == "master":
            return f"master-{self.shard_id}"
        return f"slave-{self.shard_id}.{self.replica}"


@dataclass(frozen=True)
class ProcessMesh:
    """The process-grid analogue of the device mesh: masters along one
    axis, (slave shard x replica) along the other two. The runtime spawns
    one OS process per slot; elastic replica add/remove appends or drops
    slots on the replica axis only (shard axes are fixed by the routing
    plan's partition congruence)."""

    num_master: int
    num_slave: int
    num_replicas: int

    def masters(self) -> list[ProcSlot]:
        return [ProcSlot("master", m) for m in range(self.num_master)]

    def slaves(self) -> list[ProcSlot]:
        return [ProcSlot("slave", s, r) for s in range(self.num_slave)
                for r in range(self.num_replicas)]

    def slots(self) -> list[ProcSlot]:
        return self.masters() + self.slaves()


def make_process_mesh(num_master: int, num_slave: int,
                      num_replicas: int = 1) -> ProcessMesh:
    """Raises ``ValueError`` where the reference asserts."""
    if num_master < 1 or num_slave < 1 or num_replicas < 1:
        raise ValueError(f"a process mesh needs at least one of each: "
                         f"num_master={num_master}, num_slave={num_slave}, "
                         f"num_replicas={num_replicas}")
    return ProcessMesh(num_master, num_slave, num_replicas)
