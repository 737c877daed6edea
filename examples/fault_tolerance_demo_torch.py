"""Fault-tolerance choreography on the PyTorch/CUDA port (paper §4.2 +
§4.3), the counterpart of ``examples/fault_tolerance_demo.py``: kill
replicas and master shards mid-stream, watch hot failover keep serving,
partial cold recovery restore the shard without a cluster restart, and a
domino downgrade roll the serving plane back after a poisoned update
burst. The cluster's PS row engine and sync codec run on ``--device``
(``ClusterConfig``'s torch backends: the kernels on the card, their
plain versions on the CPU).

Run: PYTHONPATH=src python examples/fault_tolerance_demo_torch.py
     [--device cuda|cpu] [--steps 30] [--batch 128]
"""

import argparse
import dataclasses
import sys

import numpy as np

sys.path.insert(0, "src")

from repro_torch.configs.weips_ctr import LR_FTRL  # noqa: E402
from repro_torch.core import ClusterConfig, WeiPSCluster  # noqa: E402
from repro_torch.data import ClickStream  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--steps", type=int, default=30,
                    help="warm-up steps before the faults")
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()

    cfg = dataclasses.replace(LR_FTRL, ftrl_l1=0.01, ftrl_alpha=0.3)
    cl = WeiPSCluster(cfg, ClusterConfig(
        num_master=4, num_slave=2, num_replicas=2, num_partitions=8,
        downgrade_metric="logloss", downgrade_threshold=0.72,
        downgrade_window=3, device=args.device))
    stream = ClickStream(feature_space=1 << 12, fields=cfg.fields,
                         signal_scale=1.0, seed=0)
    print(f"device={cl.device}")

    now = 0.0

    def run(steps, label):
        nonlocal now
        for _ in range(steps):
            ids, y = stream.batch(args.batch)
            cl.train_on_batch(ids, y, now=now)
            cl.sync_tick(now)
            now += 0.5
        print(f"[{label}] logloss={cl.validator.smoothed('logloss', 5):.4f} "
              f"auc={cl.validator.smoothed('auc', 5):.3f}")

    run(args.steps, "warm-up")
    v_stable = cl.checkpoint(now)
    print(f"checkpointed stable version v{v_stable} "
          f"(queue offsets embedded)\n")

    # ---- 1. hot failover -------------------------------------------------
    print("== kill slave replica (0,0); serving must not fail ==")
    ids_eval, _ = stream.batch(512)
    p_before = cl.predict(ids_eval)
    cl.kill_slave_replica(0, 0)
    p_after = cl.predict(ids_eval)
    print(f"failed requests: 0; prediction drift after failover: "
          f"{np.abs(p_before - p_after).max():.2e} "
          f"(failovers={cl.replica_sets[0].failovers})\n")

    # ---- 2. partial cold recovery ----------------------------------------
    print("== kill master shard 2; partial recovery, no cluster restart ==")
    rows_before = len(cl.masters[2].tables['w'])
    cl.kill_master(2)
    try:
        cl.masters[2].pull("w", np.array([1]))
    except RuntimeError:
        print("shard 2 down: training pulls fail (as expected)")
    v = cl.recover_master(2)
    cl.sync_tick(now)
    print(f"recovered shard 2 from v{v}: rows {rows_before} -> "
          f"{len(cl.masters[2].tables['w'])}; other shards untouched\n")
    run(max(1, args.steps // 3), "post-recovery")

    # ---- 3. domino downgrade ---------------------------------------------
    print("\n== adversarial shift: learned weights now predict wrongly ==")
    stream.corrupt(scale=2.0)
    for i in range(8):
        ids, y = stream.batch(args.batch)
        cl.train_on_batch(ids, y, now=now)
        cl.sync_tick(now)
        now += 0.5
        v = cl.downgrade_check(now)
        if v is not None:
            print(f"domino downgrade fired after {i+1} bad batches -> "
                  f"rolled serving back to v{v}")
            break
    else:
        print("no downgrade (threshold not crossed)")
    print(f"downgrades: {cl.downgrader.downgrades}")


if __name__ == "__main__":
    main()
