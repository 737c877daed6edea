"""The paper's sparse CTR models (LR / FM / DNN) as PyTorch functions of
the rows the parameter server supplies — counterpart of the reference's
``models/ctr.py``.

Per-example inputs are ``fields`` hashed feature ids; groups are
``{"w": 1}`` for LR, ``{"w": 1, "v": k}`` for FM and ``{"emb": k}`` plus a
dense MLP for DNN. The serve path feeds ``predict_block_fn`` the serve
cache's combined-group block on the plane's device.

Dense products are ``torch.matmul`` in full float32: PyTorch's default
``torch.backends.cuda.matmul.allow_tf32 = False``, which the predict and
loss factories state by setting it. Sums run in another order than
XLA's, and gradients come from ``torch.autograd`` where the reference
uses ``jax.value_and_grad``, so the port agrees with the reference to
``rtol=1e-5, atol=1e-6`` in fp32, not bit for bit. ``init_dense`` draws
from an explicit ``torch.Generator``: the same seed gives other numbers
than ``jax.random``, so tests carry dense tensors across.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.configs.weips_ctr import CTRConfig


def groups_for(cfg: CTRConfig) -> dict[str, int]:
    if cfg.model_type == "lr":
        return {"w": 1}
    if cfg.model_type == "fm":
        return {"w": 1, "v": cfg.embed_dim}
    if cfg.model_type == "dnn":
        return {"emb": cfg.embed_dim}
    raise ValueError(cfg.model_type)


def check_scenario_groups(scenario_groups: dict[str, int],
                          store_groups: dict[str, int]) -> None:
    """A scenario can serve off the shared parameter store only when every
    sparse group it reads exists there with the same row dim."""
    for g, dim in scenario_groups.items():
        have = store_groups.get(g)
        if have is None:
            raise ValueError(
                f"scenario group {g!r} is not in the parameter store "
                f"(store groups: {sorted(store_groups)})")
        if have != dim:
            raise ValueError(
                f"scenario group {g!r} wants dim {dim} but the store "
                f"holds dim {have}")


def dense_shapes(cfg: CTRConfig) -> dict[str, tuple[int, ...]]:
    if cfg.model_type != "dnn":
        return {}
    sizes = (cfg.fields * cfg.embed_dim,) + cfg.dnn_hidden + (1,)
    out = {}
    for i in range(len(sizes) - 1):
        out[f"mlp/w{i}"] = (sizes[i], sizes[i + 1])
        out[f"mlp/b{i}"] = (sizes[i + 1],)
    return out


def init_dense(cfg: CTRConfig,
               generator: torch.Generator) -> dict[str, np.ndarray]:
    """Initial dense head (DNN MLP) as float32 NumPy arrays: weights
    N(0, 1/fan_in) drawn from ``generator`` (a CPU generator), hidden
    biases 0.1 and the output bias 0 — embedding rows start at zero on
    the PS, so zero hidden biases would leave every ReLU at 0 with zero
    gradient and the DNN would never learn."""
    shapes = dense_shapes(cfg)
    n_layers = sum(1 for n in shapes if n.startswith("mlp/w"))
    out = {}
    for name, shape in shapes.items():
        if name.startswith("mlp/b"):
            i = int(name[len("mlp/b"):])
            out[name] = np.full(shape, 0.1 if i < n_layers - 1 else 0.0,
                                np.float32)
        else:
            out[name] = (torch.randn(shape, generator=generator,
                                     dtype=torch.float32)
                         * shape[0] ** -0.5).numpy()
    return out


# ---------------------------------------------------------------------------
# Forward / loss — functions of the gathered rows
# ---------------------------------------------------------------------------


def lr_logits(rows: dict, dense: dict) -> torch.Tensor:
    # rows["w"]: (B, F, 1)
    return rows["w"][..., 0].sum(dim=1)


def fm_logits(rows: dict, dense: dict) -> torch.Tensor:
    linear = rows["w"][..., 0].sum(dim=1)                     # (B,)
    v = rows["v"]                                             # (B, F, k)
    s = v.sum(dim=1)                                          # (B, k)
    inter = 0.5 * (s.square() - v.square().sum(dim=1)).sum(dim=-1)
    return linear + inter


def dnn_logits(rows: dict, dense: dict) -> torch.Tensor:
    emb = rows["emb"]                                         # (B, F, k)
    h = emb.reshape(emb.shape[0], -1)
    i = 0
    while f"mlp/w{i}" in dense:
        h = torch.matmul(h, dense[f"mlp/w{i}"]) + dense[f"mlp/b{i}"]
        if f"mlp/w{i+1}" in dense:
            h = torch.relu(h)
        i += 1
    return h[:, 0]


_LOGITS: dict[str, Callable] = {"lr": lr_logits, "fm": fm_logits,
                                "dnn": dnn_logits}


def _full_fp32() -> None:
    # float32 products in full float32, never TF32 (PyTorch's default,
    # stated: the serving tolerance against the reference assumes it)
    torch.backends.cuda.matmul.allow_tf32 = False


def predict_fn(cfg: CTRConfig) -> Callable:
    """``predict(rows, dense) -> (B,)`` click probabilities from per-group
    row tensors ``{group: (B, F, dim)}``."""
    f = _LOGITS[cfg.model_type]
    _full_fp32()

    def predict(rows, dense):
        return torch.sigmoid(f(rows, dense))

    return predict


def predict_block_fn(cfg: CTRConfig,
                     offsets: dict[str, tuple[int, int]]) -> Callable:
    """Predict from a combined-group row block ``(B*F, sum of dims)`` —
    the serve cache's native layout (``ServeCache.offsets``): the
    per-group split is a set of column views of the block on its device,
    so the serve path copies no per-group rows."""
    f = _LOGITS[cfg.model_type]
    fields = cfg.fields
    offs = tuple((g, lo, hi) for g, (lo, hi) in offsets.items())
    _full_fp32()

    def predict(block, dense):
        r3 = block.reshape(-1, fields, block.shape[1])
        rows = {g: r3[:, :, lo:hi] for g, lo, hi in offs}
        return torch.sigmoid(f(rows, dense))

    return predict


def _bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-example logistic loss in the reference's stable form, with
    JAX's gradients at logits == 0, which fresh all-zero rows hit
    exactly: ``maximum`` (not ``relu``) splits its gradient half and
    half as ``jnp.maximum`` does, and ``|x|`` takes slope 1 at 0 as
    ``jnp.abs`` does (``Tensor.abs`` takes 0)."""
    abs_l = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * y
            + torch.log1p(torch.exp(-abs_l)))


def _value_and_grads(loss_of, rows: dict, dense: dict):
    """``loss_of(rows, dense)`` and its gradients with respect to every
    row and dense tensor, through ``torch.autograd``; gradient dicts in
    sorted key order, as JAX returns them."""
    rows = {k: rows[k].detach().requires_grad_(True) for k in sorted(rows)}
    dense = {k: dense[k].detach().requires_grad_(True)
             for k in sorted(dense)}
    val = loss_of(rows, dense)
    leaves = [*rows.values(), *dense.values()]
    grads = torch.autograd.grad(val, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return (val.detach(), dict(zip(rows, grads[:len(rows)])),
            dict(zip(dense, grads[len(rows):])))


def loss_and_grads_fn(cfg: CTRConfig) -> Callable:
    """``(rows, dense, y) -> (mean loss, row grads, dense grads)`` on the
    tensors' device, in full fp32."""
    f = _LOGITS[cfg.model_type]
    _full_fp32()

    def loss_and_grads(rows, dense, y):
        return _value_and_grads(
            lambda r, d: _bce(f(r, d), y).mean(), rows, dense)

    return loss_and_grads


def weighted_loss_and_grads_fn(cfg: CTRConfig) -> Callable:
    """Per-example-weighted BCE — the training plane's step: ``(rows,
    dense, y, w) -> (loss, row grads, dense grads)`` with loss
    ``sum(w * bce) / max(sum(w), 1e-9)``. Weights carry negative-
    downsampling corrections and the pad-to-bucket zeros, which remove
    padded examples from the loss and every gradient."""
    f = _LOGITS[cfg.model_type]
    _full_fp32()

    def loss_and_grads(rows, dense, y, w):
        def loss_of(r, d):
            per = _bce(f(r, d), y)
            return (w * per).sum() / torch.clamp_min(w.sum(), 1e-9)
        return _value_and_grads(loss_of, rows, dense)

    return loss_and_grads
