"""Serving launcher: batched greedy decode with WeiPS hot weight updates
applied between steps (second-level deployment while serving) — the
counterpart of the reference's ``launch/serve.py``, with the same flags
plus ``--device`` (default ``cuda``; raises without a card).

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --reduced --batch 4 --steps 32 --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, ModelConfig, get_config, reduced
from repro_torch.core.ps import resolve_device
from repro_torch.models import init_params, precompute_cross_cache
from repro_torch.serving.predictor import ServeDriver


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--hot-swap-every", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args: argparse.Namespace, cfg: Optional[ModelConfig] = None):
    """The config (``cfg`` where a caller passes its own cut of a config,
    else ``args.arch``'s, reduced with ``args.reduced``), random serve
    params drawn from a generator seeded with ``args.seed`` on
    ``args.device``, the ``ServeDriver`` over them (float32 cache) and
    the generator, which the hot swaps go on drawing from. A
    model with context gets frames (batch, encoder_len, d_model) ~ N(0,
    1) drawn next from the same generator, and its driver's cross cache
    precomputed from them, as the reference's launcher does.
    Returns ``(cfg, params, driver, gen)``."""
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduced(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen)
    driver = ServeDriver(cfg=cfg, params=params, batch=args.batch,
                         max_len=args.max_len, cache_dtype=torch.float32,
                         device=dev)
    if cfg.has_encoder_context:
        frames = torch.randn((args.batch, cfg.encoder_len, cfg.d_model),
                             generator=gen, device=dev)
        precompute_cross_cache(params, cfg, driver.cache, frames)
    return cfg, params, driver, gen


def perturbed(params, gen: torch.Generator):
    """A streamed weight update: every parameter with ``ndim >= 2`` plus
    ``0.001 * N(0, 1)`` from ``gen``; vectors (norms, biases) as they are."""
    if isinstance(params, dict):
        return {k: perturbed(v, gen) for k, v in params.items()}
    if isinstance(params, list):
        return [perturbed(v, gen) for v in params]
    if params.dim() < 2:
        return params
    noise = torch.randn(params.shape, generator=gen, dtype=torch.float32,
                        device=params.device)
    return params + (0.001 * noise).to(params.dtype)


def run(driver: ServeDriver, params, args: argparse.Namespace,
        gen: torch.Generator):
    """``args.steps`` greedy steps from token 0, hot-swapping perturbed
    copies of ``params`` every ``args.hot_swap_every`` steps. Returns
    ``(tokens (batch, steps), per-step latencies in seconds)``."""
    tok = torch.zeros((args.batch, 1), dtype=torch.int32, device=driver.device)
    lat = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        tok = driver.step(tok)          # ends in a read-back of the tokens
        lat.append(time.perf_counter() - t0)
        if args.hot_swap_every and (i + 1) % args.hot_swap_every == 0:
            # simulate a streamed weight update arriving mid-decode
            driver.hot_swap(perturbed(params, gen))
            print(f"step {i}: hot-swapped serve weights (lat so far "
                  f"p50={np.median(lat) * 1e3:.1f}ms)")
    return np.stack(driver.generated, axis=1), lat


def main(argv=None) -> np.ndarray:
    """Parse ``argv``, build the driver, decode; returns the tokens."""
    args = parse_args(argv)
    _, params, driver, gen = build(args)
    tokens, lat = run(driver, params, args, gen)
    print(f"generated shape={tokens.shape}; decode p50="
          f"{np.median(lat) * 1e3:.1f}ms p99="
          f"{np.quantile(lat, .99) * 1e3:.1f}ms")
    return tokens


if __name__ == "__main__":
    main()
