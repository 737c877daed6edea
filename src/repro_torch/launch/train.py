"""Training launcher: drives ``make_train_step`` and the WeiPS
``ModelSyncEngine`` — the counterpart of the reference's
``launch/train.py``, with the same flags plus ``--device`` (default
``cuda``; raises without a card).

Example (CPU, reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --steps 50 --batch 8 --seq 128 --sync-period 1.0 \\
      --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, ModelConfig, get_config, reduced
from repro_torch.core.ps import resolve_device
from repro_torch.core.sync_engine import ModelSyncEngine, SyncConfig
from repro_torch.data import lm_batches
from repro_torch.training import init_train_state, make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--sync-period", type=float, default=1.0)
    ap.add_argument("--codec", default="cast16",
                    choices=("identity", "cast16", "int8"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args: argparse.Namespace, cfg: Optional[ModelConfig] = None):
    """The config (``cfg`` where a caller passes its own cut of a config,
    else ``args.arch``'s, reduced with ``args.reduced``), a
    ``TrainState`` drawn from a generator seeded with ``args.seed`` on
    ``args.device``, the train step, the sync engine (its replica
    bootstrapped from the initial params) and the batch stream
    (``train_batches``). Returns ``(cfg, state, step_fn, engine,
    batches)``."""
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduced(cfg, d_model=args.d_model,
                          layers_per_segment=args.layers)
    print(f"arch={cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
          f"params={cfg.param_counts()['total'] / 1e6:.1f}M device={dev}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = init_train_state(cfg, gen)
    engine = ModelSyncEngine(cfg, state.params, SyncConfig(
        gather_mode="period", period=args.sync_period, codec=args.codec,
        device=dev.type))
    return cfg, state, make_train_step(cfg), engine, train_batches(
        cfg, args, gen)


def train_batches(cfg, args: argparse.Namespace, gen: torch.Generator):
    """Each step's batch: ``{"tokens"}``, the host's (batch, seq) int32
    ids from ``lm_batches`` at ``args.seed``, and for a model with context
    ``"enc_context"``, frames (batch, encoder_len, d_model) ~ N(0, 1)
    drawn next from ``gen`` on its device. The reference's launcher
    trains on zero frames instead, which overflow whisper-medium's
    encoder backward to NaN at its 24 layers (ROADMAP queue 3)."""
    for tokens in lm_batches(cfg.vocab_size, args.batch, args.seq,
                             seed=args.seed):
        batch = {"tokens": tokens}
        if cfg.has_encoder_context:
            batch["enc_context"] = torch.randn(
                (args.batch, cfg.encoder_len, cfg.d_model), generator=gen,
                device=gen.device)
        yield batch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tick(engine: ModelSyncEngine, params: dict, now: float):
    """One ``engine.tick``; ``{"s", "records", "bytes"}`` of the flush it
    made, or None."""
    before = engine.pushed_bytes
    t = time.perf_counter()
    n = engine.tick(params, now=now)
    if not n:
        return None
    return {"s": time.perf_counter() - t, "records": n,
            "bytes": engine.pushed_bytes - before}


def run(args: argparse.Namespace, cfg, state, step_fn, engine, batches,
        clock: Optional[Callable[[int], float]] = None):
    """``args.steps`` train steps on ``batches`` (``train_batches``), each
    followed by ``collect_step`` (the tokens, and a MoE's routed expert
    counts) and a sync ``tick`` at ``clock(step)`` (default: seconds since
    the run began, as the reference launcher ticks), then the final flush.
    Returns ``(state, record)``: ``record`` holds the per-step times in
    seconds (each ends in a device sync) and pre-update losses, each
    flush's time, records and bytes, and the replica's staleness."""
    dev = resolve_device(args.device)
    t0 = time.time()
    clock = clock or (lambda i: time.time() - t0)
    step_s, losses, flushes = [], [], []
    for i in range(args.steps):
        batch = next(batches)
        tokens = batch["tokens"]
        t = time.perf_counter()
        batch = {**batch, "tokens": torch.from_numpy(tokens).to(dev)}
        state, metrics = step_fn(state, batch)
        _sync(dev)
        step_s.append(time.perf_counter() - t)
        losses.append(float(metrics["loss"]))
        engine.collect_step(tokens, metrics)
        flush = _tick(engine, state.params, clock(i))
        if flush:
            flushes.append(flush)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss={losses[-1]:.4f} "
                  f"ce={float(metrics['ce']):.4f} "
                  f"wall={time.time() - t0:.1f}s")
    final = _tick(engine, state.params, 1e9)            # final flush
    if final:
        flushes.append(final)
    staleness = engine.replicas[0].staleness(state.params)
    print("sync metrics:", engine.metrics())
    print(f"serve staleness vs train params: {staleness:.2e}")
    return state, {"step_s": step_s, "losses": losses, "flushes": flushes,
                   "staleness": staleness}


def main(argv=None):
    """Parse ``argv``, build, train and sync; returns ``(state, engine,
    record)``."""
    args = parse_args(argv)
    cfg, state, step_fn, engine, batches = build(args)
    state, record = run(args, cfg, state, step_fn, engine, batches)
    print(f"step p50={np.median(record['step_s']) * 1e3:.1f}ms "
          f"flushes={len(record['flushes'])}")
    return state, engine, record


if __name__ == "__main__":
    main()
