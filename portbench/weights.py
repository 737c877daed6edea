"""The benchmark's inputs made from ``--seed``: a model's weights in the
port's parameter layout, a KV cache's seeded rows, and token ids.

Every tensor is drawn by a generator of its own, seeded from ``(seed,
name)``, on the device and in one call, so that either side can make any
one of them again alone: the program gets them in its serving dtype, the
reference the same values in float32.

The layout is the port's plain dict, the benchmark's data format for
both sides; each family's file (``reference/<family>.py``,
``leaf_specs``) gives its paths, shapes and inits. Init scales follow
the published recipes where they matter to the numbers: matmul weights
N(0, 1 / fan_in); norm gains and biases N(0, 0.1) (so that a dropped
gain or bias shows).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np


def leaf_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed for ``name`` under ``seed`` (any integer)."""
    h = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, name: str, device):
    import torch
    return torch.Generator(device=device).manual_seed(leaf_seed(seed, name))


def _normal(shape, std, g, device):
    import torch
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.float32).mul_(std)


def leaf_specs(spec: dict) -> dict:
    """``{path: (shape, init, arg, float32)}`` of every parameter, as the
    configuration's family (``reference/<family>.py``) lays them out:
    init ``normal`` (std ``arg``), ``uniform_log`` (log of U[arg]),
    ``dt_bias`` (inverse softplus of a log-uniform dt in ``arg``),
    ``ones``; ``float32`` marks leaves kept in float32."""
    from portbench.harness import family_module
    return family_module(spec["family"]).leaf_specs(spec)


def make_leaf(spec: dict, seed: int, path: str, device, dtype: str,
              tag: str = "") -> "torch.Tensor":
    """One parameter: ``dtype`` (a float32 leaf stays float32) on
    ``device``; the same values every time for the same ``(seed, tag,
    path)`` on the same device. ``dtype`` float32 gives the served
    dtype's values in float32 (what the reference reads)."""
    import torch
    shape, init, arg, keep_f32 = leaf_specs(spec)[path]
    g = generator(seed, f"{tag}weights/{path}", device)
    if init == "normal":
        w = _normal(shape, arg, g, device)
    elif init == "ones":
        w = torch.ones(shape, dtype=torch.float32, device=device)
    else:
        lo, hi = arg
        u = torch.rand(shape, generator=g, device=device,
                       dtype=torch.float32)
        if init == "uniform_log":
            w = torch.log(lo + (hi - lo) * u)
        else:   # dt_bias: dt log-uniform in [lo, hi], inverse softplus
            dt = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)
            w = dt + torch.log(-torch.expm1(-dt))
    if keep_f32:
        return w
    served = getattr(torch, spec["torch_dtype"])
    w = w.to(served)
    return w if dtype == spec["torch_dtype"] else w.to(getattr(torch, dtype))


def set_path(tree: dict, path: str, value) -> None:
    parts = path.split("/")
    node = tree
    for i, p in enumerate(parts[:-1]):
        nxt = parts[i + 1]
        if p.isdigit():
            p = int(p)
            while len(node) <= p:
                node.append({})
        elif p not in node:
            node[p] = [] if nxt.isdigit() else {}
        node = node[p]
    node[parts[-1]] = value


def make_params(spec: dict, seed: int, device, dtype: str,
                tag: str = "") -> dict:
    """Every parameter (``make_leaf``) in the port's nested layout."""
    tree: dict = {}
    for path in leaf_specs(spec):
        set_path(tree, path, make_leaf(spec, seed, path, device, dtype, tag))
    return tree


def zipf_ids(seed: int, name: str, n: int, vocab: int,
             exponent: float) -> np.ndarray:
    """``n`` token ids (int64) from a Zipf law over ``vocab`` ids: rank r
    drawn with weight 1 / r^exponent, the ranks scattered over the ids by a
    permutation drawn from ``seed`` (the same for every draw of a run)."""
    perm = np.random.default_rng(leaf_seed(seed, "zipf/perm")).permutation(
        vocab)
    cdf = np.cumsum(1.0 / np.arange(1, vocab + 1) ** exponent)
    cdf /= cdf[-1]
    u = np.random.default_rng(leaf_seed(seed, name)).random(n)
    ranks = np.minimum(np.searchsorted(cdf, u, side="right"), vocab - 1)
    return perm[ranks]


def cache_rows(seed: int, layer: int, which: str, shape, device, dtype):
    """The seeded KV cache of one layer, ``which`` ``k`` or ``v``: N(0, 1)
    in ``dtype``'s values (float32 gives the bf16 values widened)."""
    import torch
    g = generator(seed, f"cache/{layer}/{which}", device)
    w = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    w = w.to(torch.bfloat16)
    return w if dtype == torch.bfloat16 else w.to(dtype)
