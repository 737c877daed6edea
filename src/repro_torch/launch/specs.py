"""Process launch specs for the multi-process cluster runtime
(``launch/runtime.py``): the process half of the reference's
``launch/specs.py``. The abstract model specs of its other half are not
ported yet."""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

from repro_torch.launch.mesh import ProcessMesh, ProcSlot


@dataclass(frozen=True)
class ProcSpec:
    """Everything needed to launch (or relaunch) one worker process: the
    grid slot it fills, its RPC socket path, and the exact argv. Respawn
    after a SIGKILL reuses the same spec — the socket path is stable per
    slot, so the supervisor reconnects without renegotiation."""

    slot: ProcSlot
    root: str                         # runtime directory (queue/ckpt/sock)
    argv: tuple[str, ...]
    socket: str
    log_path: str

    @property
    def name(self) -> str:
        return self.slot.name


def proc_spec_for(slot: ProcSlot, root: str) -> ProcSpec:
    """Launch spec for one grid slot. Workers run the package entry
    ``python -m repro_torch.launch.worker`` against the shared runtime
    dir; role/shard/replica arrive as argv, the device and backends in
    ``<root>/runtime.json``."""
    socket = os.path.join(root, "sock", f"{slot.name}.sock")
    log_path = os.path.join(root, "logs", f"{slot.name}.log")
    argv = (sys.executable, "-m", "repro_torch.launch.worker",
            "--role", slot.role, "--shard", str(slot.shard_id),
            "--replica", str(-1 if slot.replica is None else slot.replica),
            "--root", root, "--socket", socket)
    return ProcSpec(slot=slot, root=root, argv=argv, socket=socket,
                    log_path=log_path)


def plan_cluster_procs(pmesh: ProcessMesh, root: str) -> list[ProcSpec]:
    """Placement for a whole cluster: one spec per ``ProcessMesh`` slot
    (masters first, then slave replicas)."""
    return [proc_spec_for(slot, root) for slot in pmesh.slots()]
