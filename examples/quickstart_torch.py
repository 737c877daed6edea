"""Quickstart on the PyTorch/CUDA port — the paper's workload end to end:
large-scale sparse CTR online learning on WeiPS, driven through the
online training plane, with the PS row engine, the sync codec and the
checkpoint codec on the card (``ClusterConfig``'s defaults).

One process simulates the whole symmetric fusion cluster: a click
stream emits exposure/feedback events; the SampleJoiner window-joins
them into labeled samples; the TrainPipeline trains them in buckets
against 4 master PS shards (FM-FTRL: probe + fused FTRL pass on the
card); the streaming sync pipeline (collect -> gather -> int8 push ->
scatter) deploys every update to 2 slave shards x 2 hot replicas within
one tick; predictors serve from the slaves; windowed progressive
validation monitors quality; int8 delta-chain checkpoints and the
domino downgrade guard stability.

Run: PYTHONPATH=src python examples/quickstart_torch.py [--steps 300]
     [--device cuda|cpu]
"""

import argparse
import dataclasses
import sys
import time

sys.path.insert(0, "src")

from repro_torch.configs.weips_ctr import FM_FTRL  # noqa: E402
from repro_torch.core import ClusterConfig, WeiPSCluster  # noqa: E402
from repro_torch.core.monitor import auc  # noqa: E402
from repro_torch.data import ClickStream  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--gather-mode", default="realtime",
                    choices=("realtime", "threshold", "period"))
    ap.add_argument("--codec", default="int8",
                    choices=("identity", "cast16", "int8"))
    ap.add_argument("--join-window", type=float, default=3.0)
    ap.add_argument("--emit-on-feedback", action="store_true",
                    help="positives train the moment feedback arrives")
    args = ap.parse_args()

    # FTRL's l1 as the serving tests set it: with l1 = 1 every weight of
    # a short run stays 0 and every prediction is 0.5
    cfg = dataclasses.replace(FM_FTRL, ftrl_l1=0.01, ftrl_alpha=0.2)
    cluster = WeiPSCluster(cfg, ClusterConfig(
        num_master=4, num_slave=2, num_replicas=2, num_partitions=8,
        gather_mode=args.gather_mode, codec=args.codec,
        ckpt_compress="int8", local_ckpt_interval=5.0,
        remote_ckpt_interval=60.0, join_window=args.join_window,
        device=args.device))
    pipeline = cluster.make_train_pipeline(
        emit_on_feedback=args.emit_on_feedback)
    stream = ClickStream(feature_space=1 << 18, fields=cfg.fields,
                         zipf_a=1.2, signal_scale=0.8, feedback_delay=1.0,
                         seed=0)
    scn = cluster.training.scenario()

    print(f"model={cfg.name} optimizer={cfg.optimizer} codec={args.codec} "
          f"gather={args.gather_mode} join_window={args.join_window}s "
          f"device={cluster.device}")
    t_start = time.time()
    now = 0.0
    for step in range(args.steps):
        # stream -> join -> admit -> dedup -> bucketed train ...
        pipeline.ingest(stream.events_batch(args.batch, now))
        cluster.train_scheduler.tick(now)
        cluster.sync_tick(now)                 # ... -> second-level deploy
        cluster.maybe_checkpoint(now)
        cluster.downgrade_check(now)
        now += 0.2
        if step % 50 == 0 or step == args.steps - 1:
            sm = cluster.sync_metrics(now)
            tm = sm["training"]["scenarios"][scn.name]
            jm = tm["pipeline"]["joiner"]
            print(f"step {step:4d} trained={tm['examples']:6d} "
                  f"logloss={tm['logloss']:.4f} auc={tm['auc']:.3f} "
                  f"calib={tm['calibration']:.2f} "
                  f"dedup={tm['dedup_ratio']:.2f} "
                  f"join_p50={jm['join_delay']['p50']:.1f}s "
                  f"in_flight={jm['in_flight']} "
                  f"sync_lag={sm['sync_lag_seconds']:.2f}s")
    cluster.train_scheduler.flush(now + args.join_window + 1)
    cluster.sync_tick(now + args.join_window + 1)

    # --- serve from the slave plane and compare with ground truth -------
    ids, y = stream.batch(2048)
    p = cluster.predict(ids)
    rows_total = sum(len(m.tables[g]) for m in cluster.masters
                     for g in cluster.groups)
    print(f"\nserving-plane AUC on fresh traffic: {auc(y, p):.3f}")
    print(f"PS rows: {rows_total}  checkpoints: "
          + ", ".join(f"v{v} {cluster.store.load(v).kind}"
                      for v in cluster.store.versions()))
    print(f"windowed progressive validation: "
          f"logloss={scn.evaluator.smoothed('logloss'):.4f} "
          f"auc={scn.evaluator.smoothed('auc'):.3f} "
          f"calibration={scn.evaluator.smoothed('calibration'):.3f}")
    jm = pipeline.metrics()["joiner"]
    print(f"joiner: emitted={jm['emitted']} late={jm['late_feedback']} "
          f"fast={jm['fast_emits']} "
          f"delay p50/p99={jm['join_delay']['p50']:.1f}/"
          f"{jm['join_delay']['p99']:.1f}s")
    print(f"wall: {time.time()-t_start:.1f}s for {args.steps} online steps")


if __name__ == "__main__":
    main()
