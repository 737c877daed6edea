"""Train a small LM (≈15M params, qwen2-family reduced config) for a few
hundred steps on the PyTorch/CUDA port, with the WeiPS ModelSyncEngine
streaming weights to a serve replica throughout — then decode from the
SERVE replica to prove the deployed model works.

Run: PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
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
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--sync-period", type=float, default=2.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()

    dev = torch.device(args.device)
    cfg = reduced(get_config(args.arch), d_model=args.d_model,
                  layers_per_segment=args.layers, vocab=args.vocab)
    n_params = cfg.param_counts()["total"]
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M layers="
          f"{cfg.num_layers} vocab={cfg.vocab_size} device={dev}")

    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0))
    step_fn = make_train_step(cfg)
    engine = ModelSyncEngine(cfg, state.params, SyncConfig(
        gather_mode="period", period=args.sync_period, codec="cast16",
        device=dev.type))

    batches = lm_batches(cfg.vocab_size, args.batch, args.seq, seed=0)
    t0 = time.time()
    losses = []
    for i in range(args.steps):
        tokens = next(batches)
        state, metrics = step_fn(state, {"tokens": torch.from_numpy(
            tokens).to(dev)})
        losses.append(float(metrics["loss"]))
        engine.collect_step(tokens, {})
        engine.tick(state.params, now=time.time() - t0)
        if i % 25 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={losses[-1]:.4f} "
                  f"(avg10={np.mean(losses[-10:]):.4f}) "
                  f"wall={time.time()-t0:.1f}s")
    engine.tick(state.params, now=1e9)

    print(f"\nloss first10={np.mean(losses[:10]):.4f} -> "
          f"last10={np.mean(losses[-10:]):.4f}")
    print("sync:", engine.metrics())
    print("serve staleness:",
          f"{engine.replicas[0].staleness(state.params):.2e}")

    # decode from the STREAMED serve replica (the deployed model)
    serve_params = engine.replicas[0].device_params(dtype="float32",
                                                    device=dev)
    driver = ServeDriver(cfg=cfg, params=serve_params, batch=4, max_len=32,
                         cache_dtype=torch.float32, device=dev)
    out = driver.generate(torch.zeros((4, 1), dtype=torch.int32,
                                      device=dev), steps=16)
    print(f"greedy decode from serve replica: shape={out.shape}, "
          f"tokens[0]={out[0][:8].tolist()}")


if __name__ == "__main__":
    main()
