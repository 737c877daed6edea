"""Heterogeneous-cluster migration (paper §4.2.1d) on the PyTorch/CUDA
port, the counterpart of ``examples/reshard_migration.py``: train on a
10-shard master cluster, checkpoint, load the checkpoint into a fresh
20-shard cluster via the dynamic-routing recovery, and prove bit-identical
serving behaviour across the migration. Every master's rows (and the
fused FTRL push) run on ``--device``, and so does the checkpoint codec.

Run: PYTHONPATH=src python examples/reshard_migration_torch.py
     [--device cuda|cpu] [--steps 40] [--batch 256]
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, "src")

from repro_torch.core import RoutingPlan  # noqa: E402
from repro_torch.core.fault_tolerance import (BackupPolicy,  # noqa: E402
                                              CheckpointStore, ColdBackup)
from repro_torch.core.ps import MasterShard  # noqa: E402
from repro_torch.data import ClickStream  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    opt = get_optimizer("ftrl", alpha=0.3, l1=0.01)
    groups = {"w": 1}
    engine = dict(backend="torch", device=args.device)

    # ---- cluster A: 10 shards ------------------------------------------
    plan_a = RoutingPlan(num_master=10, num_slave=1, num_partitions=1)
    cluster_a = [MasterShard(i, groups, opt, **engine) for i in range(10)]
    stream = ClickStream(feature_space=1 << 16, fields=16, signal_scale=1.0)
    for step in range(args.steps):
        ids, _ = stream.batch(args.batch)
        uniq = np.unique(ids.reshape(-1))
        grads = rng.normal(size=(len(uniq), 1)).astype(np.float32) * 0.1
        for sid, sids in plan_a.split_by_master(uniq).items():
            pos = np.searchsorted(uniq, sids)
            cluster_a[sid].push_grad("w", sids, grads[pos], step=step)
    rows_a = sum(len(s.tables["w"]) for s in cluster_a)
    print(f"cluster A (10 shards on {args.device}): {rows_a} rows")

    store = CheckpointStore()
    backup = ColdBackup(cluster_a, store, BackupPolicy(),
                        codec_backend="torch", device=args.device)
    v = backup.checkpoint(now=0.0)
    print(f"checkpoint v{v} written by 10 shards")

    # ---- migrate to cluster B: 20 shards --------------------------------
    plan_b = RoutingPlan(num_master=20, num_slave=1, num_partitions=1)
    cluster_b = [MasterShard(i, groups, opt, **engine) for i in range(20)]
    backup.recover_all(cluster_b, version=v, owner_of=plan_b.master_shard)
    rows_b = sum(len(s.tables["w"]) for s in cluster_b)
    print(f"cluster B (20 shards): {rows_b} rows "
          f"({'no rows lost' if rows_b == rows_a else 'MISMATCH'})")
    if rows_b != rows_a:
        raise SystemExit(1)

    # every id lives on exactly its new owner, with identical values
    probe, _ = stream.batch(64)
    uniq = np.unique(probe.reshape(-1))
    w_a = np.zeros((len(uniq), 1), np.float32)
    for sid, sids in plan_a.split_by_master(uniq).items():
        pos = np.searchsorted(uniq, sids)
        w_a[pos] = cluster_a[sid].pull("w", sids, create=False)
    w_b = np.zeros((len(uniq), 1), np.float32)
    for sid, sids in plan_b.split_by_master(uniq).items():
        pos = np.searchsorted(uniq, sids)
        w_b[pos] = cluster_b[sid].pull("w", sids, create=False)
    np.testing.assert_array_equal(w_a, w_b)
    print(f"probe of {len(uniq)} ids: values bit-identical across the "
          "10->20 shard migration")
    for sid in range(20):
        ids = cluster_b[sid].tables["w"].all_ids()
        if not (plan_b.master_shard(ids) == sid).all():
            raise SystemExit(f"shard {sid} holds rows it does not own")
    print("ownership verified: every row sits on its plan-B owner shard")


if __name__ == "__main__":
    main()
