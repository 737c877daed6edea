"""Device meshes, the card's constants, and process placement — the
counterpart of the reference's ``launch/mesh.py``.

Functions, not module-level meshes: importing this module creates no
process group and touches no device. ``make_production_mesh`` builds the
reference's mesh shapes and axis names as a ``DeviceMesh`` over the
default process group, which must already have that many ranks (the
dry-run's fake group: ``fake_process_group``); ``make_local_mesh`` one
over the devices a single process has — the one card, or the CPU in
tests — creating a world-size-1 group when none exists.

The constants are the H100 SXM5 80 GB's, from NVIDIA's datasheet, and
stand where the reference's TPU v5e figures do. The collective term's
link: a 16-wide ``model`` axis spans two 8-GPU NVLink nodes, so its
slowest hop is the inter-node network, one 400 Gb/s NDR InfiniBand port
(ConnectX-7) a GPU on a DGX H100 — 50 GB/s each way.

The process half: every worker process of a runtime grid shares the one
card through the explicit device index in ``RuntimeConfig.device``; that
grid is of processes, not devices."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

# NVIDIA H100 SXM5 80 GB (per GPU) for the roofline model
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 tensor cores
PEAK_FLOPS_FP32 = 67e12           # FLOP/s, fp32 outside the tensor cores
HBM_BW = 3.35e12                  # bytes/s, HBM3
HBM_BYTES = 80e9                  # bytes of device memory
ICI_LINK_BW = 50e9                # bytes/s a GPU: one 400 Gb/s NDR port


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production mesh: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")`` —
    256 or 512 GPUs. The default process group must have that many
    ranks (``fake_process_group`` for a dry-run); raises ``RuntimeError``
    otherwise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device_type: str = "cuda"):
    """A ``(data, model)`` mesh over this process's devices: with no
    process group, a world-size-1 group (gloo over a ``HashStore``: one
    rank never communicates, on the card or the CPU) is created, so only
    ``(1, 1)`` fits; an existing group must have ``data * model``
    ranks."""
    import torch.distributed as dist
    if not dist.is_initialized():
        if data * model != 1:
            raise RuntimeError(f"a ({data}, {model}) mesh needs a process "
                               f"group of {data * model} ranks")
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return _mesh(device_type, (data, model), ("data", "model"))


def _mesh(device_type: str, shape: tuple, axes: tuple):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(f"a {shape} mesh needs a process group of {n} "
                           f"ranks, have {have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A default process group of ``world_size`` fake ranks (this process
    is rank 0; collectives record and move nothing), destroyed on exit.
    Raises ``RuntimeError`` if a group already exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


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
