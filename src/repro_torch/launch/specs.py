"""Abstract input specs for the dry-run, and process launch specs for the
multi-process cluster runtime — the counterpart of the reference's
``launch/specs.py``.

Where the reference builds ``ShapeDtypeStruct``s with ``NamedSharding``s,
each leaf here is a ``DTensor`` on ``m.mesh`` built from its local shard:
a fake tensor (``FakeTensorMode``: shape, dtype and strides, no data) of
the shard's shape (``sharding.local_shape``), wrapped with
``DTensor.from_local(..., shape=, stride=)`` and the placements of its
``PartitionSpec`` — so nothing is allocated and no collective runs to
set the step up. The global shapes come from running the initialisers
under a fake mode (``jax.eval_shape``'s counterpart) or from
``init_cache(abstract=True)``'s meta tensors. Every leaf of one call
shares one fake mode: the one active, else a new one.

The process half (``ProcSpec`` and the placement of a runtime grid)
starts each worker with ``python -m repro_torch.launch.worker``.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.core.tree import map_like
from repro_torch.launch.mesh import ProcessMesh, ProcSlot
from repro_torch.models import init_cache, init_params
from repro_torch.models.sharding import (MeshInfo, P, batch_pspecs,
                                         cache_pspecs, local_shape,
                                         param_pspecs, placements)
from repro_torch.optim import Optimizer, get_optimizer
from repro_torch.training.trainer import TrainState

PyTree = Any


def _fake_mode():
    """The active ``FakeTensorMode``, else a new one."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    return detect_fake_mode() or FakeTensorMode()


def _meta_tree(fn) -> PyTree:
    """The tree ``fn()`` returns, run on fake tensors, as meta tensors of
    the same shapes and dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = fn()
    return map_like(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def abstract_leaf(shape, dtype: torch.dtype, spec: P, m: MeshInfo,
                  fake_mode=None):
    """A ``DTensor`` of global ``shape`` laid out by ``spec`` on
    ``m.mesh``, its local shard a fake tensor of device 0's shard shape
    on the mesh's device type."""
    from torch.distributed.tensor import DTensor
    fake_mode = fake_mode or _fake_mode()
    with fake_mode:
        local = torch.empty(local_shape(tuple(shape), spec, m), dtype=dtype,
                            device=m.mesh.device_type)
    shape = torch.Size(shape)
    return DTensor.from_local(local, m.mesh, placements(spec, m.mesh),
                              run_check=False, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def _with_shardings(abstract: PyTree, pspecs: PyTree, m: MeshInfo,
                    fake_mode=None) -> PyTree:
    fake_mode = fake_mode or _fake_mode()
    return map_like(lambda t, spec: abstract_leaf(t.shape, t.dtype, spec, m,
                                                  fake_mode),
                    abstract, pspecs)


def _param_shapes(cfg: ModelConfig) -> PyTree:
    return _meta_tree(lambda: init_params(cfg, torch.Generator()))


def abstract_params(cfg: ModelConfig, m: MeshInfo, fake_mode=None) -> PyTree:
    return _with_shardings(_param_shapes(cfg), param_pspecs(cfg, m), m,
                           fake_mode)


def _slot_spec(param_spec: P, param_sds, slot_sds) -> P:
    """Match optimizer-slot sharding to its parameter's sharding."""
    if slot_sds.shape == param_sds.shape:
        return param_spec
    if slot_sds.shape == param_sds.shape[:-1]:               # adafactor vr
        return P(*param_spec[:-1]) if len(param_spec) else P()
    if slot_sds.shape == param_sds.shape[:-2] + param_sds.shape[-1:]:
        return P(*(tuple(param_spec[:-2]) + tuple(param_spec[-1:])))
    return P(*([None] * len(slot_sds.shape)))


def abstract_train_state(cfg: ModelConfig, m: MeshInfo,
                         optimizer: Optional[Optimizer] = None,
                         fake_mode=None) -> TrainState:
    """Params and optimizer slots as ``DTensor``s (each slot laid out as
    its param, by ``_slot_spec``: Adam's ``m`` and ``v`` as the param,
    Adafactor's ``vr`` / ``vc`` without its last / second-last axis), and
    step 0."""
    opt = optimizer or get_optimizer(cfg.optimizer)
    fake_mode = fake_mode or _fake_mode()
    p_shapes = _param_shapes(cfg)
    s_shapes = opt.init_slots_tree(p_shapes)
    pspecs = param_pspecs(cfg, m)

    def slot_specs(param_spec, param_sds, slots):
        return {name: _slot_spec(param_spec, param_sds, sds)
                for name, sds in slots.items()}

    sspecs = map_like(slot_specs, pspecs, p_shapes, s_shapes)
    params = _with_shardings(p_shapes, pspecs, m, fake_mode)
    slots = map_like(lambda _, sl, sp: {k: abstract_leaf(v.shape, v.dtype,
                                                         sp[k], m, fake_mode)
                                        for k, v in sl.items()},
                     pspecs, s_shapes, sspecs)
    return TrainState(params=params, slots=slots, step=0)


def abstract_cache(cfg: ModelConfig, m: MeshInfo, batch: int,
                   seq_len: int, kv_quant: bool = False,
                   fake_mode=None) -> PyTree:
    shapes = init_cache(cfg, batch, seq_len, dtype=torch.bfloat16,
                        abstract=True, kv_quant=kv_quant)
    return _with_shardings(shapes, cache_pspecs(cfg, m, batch, kv_quant), m,
                           fake_mode)


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


def input_specs(cfg: ModelConfig, shape: InputShape, m: MeshInfo,
                kv_quant: bool = False, fake_mode=None) -> dict[str, PyTree]:
    """Step arguments (beyond model state) for this input shape."""
    b = shape.global_batch
    bspecs = batch_pspecs(cfg, m, shape.kind, b)
    fake_mode = fake_mode or _fake_mode()

    def sds(shp, dtype, spec):
        return abstract_leaf(shp, dtype, spec, m, fake_mode)

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": sds((b, shape.seq_len), torch.int32,
                               bspecs["tokens"])}
        if cfg.has_encoder_context:
            batch["enc_context"] = sds(
                (b, cfg.encoder_len, cfg.d_model), torch.bfloat16,
                bspecs["enc_context"])
        return {"batch": batch}
    # decode: one new token against a seq_len cache
    return {
        "tokens": sds((b, 1), torch.int32, bspecs["tokens"]),
        "pos": sds((b,), torch.int32, bspecs["pos"]),
        "cache": abstract_cache(cfg, m, b, shape.seq_len,
                                kv_quant=kv_quant, fake_mode=fake_mode),
    }
