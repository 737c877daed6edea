"""Batched LM serving on the PyTorch/CUDA port, with second-level weight
deployment: a background "training" process keeps improving the model;
the WeiPS sync engine streams the updates; the serving driver hot-swaps
them BETWEEN decode steps without dropping in-flight sequences (the KV
cache survives the swap). The default gemma3-4b (reduced) mixes
sliding-window layers, whose decode cache is a ring of ``window`` rows,
with global ones.

Run: PYTHONPATH=src python examples/serve_lm_torch.py [--decode-steps 48]
     [--device cuda|cpu]
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.sync_engine import (ModelSyncEngine,  # noqa: E402
                                          SyncConfig)
from repro_torch.data import lm_batches  # noqa: E402
from repro_torch.serving.predictor import ServeDriver  # noqa: E402
from repro_torch.training import (init_train_state,  # noqa: E402
                                  make_train_step)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--decode-steps", type=int, default=48)
    ap.add_argument("--train-every", type=int, default=8,
                    help="train+sync cadence, in decode steps")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()

    dev = torch.device(args.device)
    cfg = reduced(get_config(args.arch), vocab=1024)
    print(f"serving {cfg.name}: {cfg.param_counts()['total']/1e6:.1f}M "
          f"params, window={cfg.window_size}, device={dev}")

    # training plane
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0))
    train_step = make_train_step(cfg)
    engine = ModelSyncEngine(cfg, state.params, SyncConfig(
        gather_mode="realtime", codec="cast16", device=dev.type))
    batches = lm_batches(cfg.vocab_size, 8, 64, seed=1)

    # serving plane starts from the replica's bootstrap state
    driver = ServeDriver(
        cfg=cfg, params=engine.replicas[0].device_params(dtype="float32",
                                                         device=dev),
        batch=args.batch, max_len=args.decode_steps + 1,
        cache_dtype=torch.float32, device=dev)

    tok = torch.zeros((args.batch, 1), dtype=torch.int32, device=dev)
    swaps, lat = 0, []
    for i in range(args.decode_steps):
        t0 = time.perf_counter()
        tok = driver.step(tok)          # ends in a read-back of the tokens
        lat.append(time.perf_counter() - t0)
        if (i + 1) % args.train_every == 0:
            # the training plane advances; updates stream to the replica
            state, m = train_step(state, {"tokens": torch.from_numpy(
                next(batches)).to(dev)})
            engine.collect_step(next(batches), {})
            engine.tick(state.params, now=float(i))
            driver.hot_swap(engine.replicas[0].device_params(
                dtype="float32", device=dev))
            swaps += 1
            print(f"decode step {i+1}: hot-swapped serve weights "
                  f"(train loss {float(m['loss']):.3f}, "
                  f"staleness {engine.replicas[0].staleness(state.params):.1e})")

    gen = np.stack(driver.generated, axis=1)
    print(f"\ngenerated {gen.shape} tokens across {swaps} weight swaps "
          f"with uninterrupted KV caches")
    print(f"decode latency p50={np.median(lat)*1e3:.1f}ms "
          f"p99={np.quantile(lat, 0.99)*1e3:.1f}ms")
    print(f"sync: {engine.metrics()}")


if __name__ == "__main__":
    main()
