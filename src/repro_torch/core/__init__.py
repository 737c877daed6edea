"""Parameter-server core of the port: hash map, routing, sparse tables,
master and slave shards, the train→serve transform, the queue and the
sync stream, checkpoints and recovery, domino downgrade, the scheduler,
and the end-to-end ``WeiPSCluster``.

Exports resolve lazily (PEP 562), as in the reference's package:
``from repro_torch.core import X`` imports only the submodule that
defines ``X``, so the PS and queue layer load without the training and
serving planes the cluster pulls in.
"""

_EXPORTS = {
    "ClusterConfig": "repro_torch.core.cluster",
    "WeiPSCluster": "repro_torch.core.cluster",
    "DenseBank": "repro_torch.core.ps",
    "IdHashMap": "repro_torch.core.hashmap",
    "MasterShard": "repro_torch.core.ps",
    "SlaveShard": "repro_torch.core.ps",
    "SparseTable": "repro_torch.core.ps",
    "Consumer": "repro_torch.core.queue",
    "FileQueue": "repro_torch.core.queue",
    "PartitionedQueue": "repro_torch.core.queue",
    "Record": "repro_torch.core.queue",
    "RoutingPlan": "repro_torch.core.routing",
    "owner_segments": "repro_torch.core.routing",
    "reshard_plan": "repro_torch.core.routing",
    "Collector": "repro_torch.core.streaming",
    "Gatherer": "repro_torch.core.streaming",
    "Pusher": "repro_torch.core.streaming",
    "Scatter": "repro_torch.core.streaming",
    "SyncPipeline": "repro_torch.core.streaming",
    "Cast16Transform": "repro_torch.core.transform",
    "Int8Transform": "repro_torch.core.transform",
    "Transform": "repro_torch.core.transform",
    "decode_record": "repro_torch.core.transform",
    "make_transform": "repro_torch.core.transform",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'repro_torch.core' has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
