#!/usr/bin/env python3
"""Decode against forward for a deep Mamba-2 stack, in the JAX package
and in the port, on the CPU: how far a model of ``--layers`` Mamba-2
layers of width ``--d-model`` (mamba2-1.3b's other widths, a vocabulary
of 4,096) with random weights decodes ``--tokens`` tokens one at a time
from a fresh cache away from one forward over the same tokens, in
float32 and in bfloat16 (params and cache). Prints the largest |logit|
deviation over the vocabulary and the share of greedy tokens that agree,
for each package and dtype. The port's float32 decode and forward are
also held against its float64 forward (``chip_smoke.float64_math``).

It shows the rounding floor that the smoke's phase 6c meets at full
depth: 48 layers of random weights amplify rounding, in the reference as
in the port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/ssm_decode_drift.py \\
        --d-model 512 --layers 48
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def reference(d_model: int, layers: int, tokens: np.ndarray, dtype: str):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.configs.base import Segment
    from repro.models import decode_step, forward, init_cache, init_params
    base = get_config("mamba2-1.3b")
    cfg = dataclasses.replace(
        base, d_model=d_model, vocab_size=4096, dtype=dtype,
        param_dtype=dtype, remat=False,
        segments=(Segment(base.segments[0].pattern, layers),))
    params = init_params(cfg, jax.random.PRNGKey(0))
    tok = jnp.asarray(tokens)
    full, _ = jax.jit(lambda p, t: forward(p, cfg, t))(params, tok)
    cache = init_cache(cfg, tok.shape[0], tok.shape[1],
                       dtype=jnp.dtype(dtype))
    step = jax.jit(lambda c, t, p: decode_step(params, cfg, c, t, p))
    out = []
    for t in range(tok.shape[1]):
        lg, cache = step(cache, tok[:, t:t + 1],
                         jnp.full((tok.shape[0],), t, jnp.int32))
        out.append(lg)
    dec = np.asarray(jnp.stack(out, 1).astype(jnp.float32))[..., :4096]
    return dec, np.asarray(full.astype(jnp.float32))[..., :4096]


def port(d_model: int, layers: int, tokens: np.ndarray):
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.configs.base import Segment
    from repro_torch.models import init_params
    base = get_config("mamba2-1.3b")
    cfg = dataclasses.replace(
        base, d_model=d_model, vocab_size=4096, remat=False,
        segments=(Segment(base.segments[0].pattern, layers),))
    params = init_params(cfg, torch.Generator().manual_seed(0))
    return cs.decode_vs_forward(cfg, params, torch.from_numpy(tokens),
                                torch.device("cpu"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--tokens", type=int, default=64)
    args = ap.parse_args(argv)
    tokens = np.random.default_rng(1).integers(
        0, 4096, size=(2, args.tokens)).astype(np.int32)
    for dtype in ("float32", "bfloat16"):
        dec, full = reference(args.d_model, args.layers, tokens, dtype)
        print(f"reference {dtype}: decode vs forward max deviation "
              f"{np.abs(dec - full).max():.3g}, greedy tokens agree "
              f"{(dec.argmax(-1) == full.argmax(-1)).mean():.4f}")
    res = port(args.d_model, args.layers, tokens)
    print(f"port float64: decode vs forward max deviation "
          f"{res['float64']['dev'][0]:.3g}")
    for dtype in ("float32", "bf16"):
        r = res[dtype]
        print(f"port {dtype}: decode vs forward max deviation "
              f"{r['dev'][0]:.3g}, greedy tokens agree {r['dev'][1]:.4f}; "
              f"from the float64 forward: decode {r['dec']:.3g}, forward "
              f"{r['fwd']:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
