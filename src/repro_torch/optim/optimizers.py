"""Optimizers with *named slots* — counterpart of the reference's
``optim/optimizers.py``: the contract the parameter server and its
train→serve transform operate on (paper §1.2.1 "heterogeneous
parameters").

Each optimizer exposes:
  * ``init_slots(param)``       — auxiliary training state per parameter
    (NumPy for a NumPy param, a tensor on the param's device for a
    tensor);
  * ``update(param, slots, grad, step)`` — one elementwise step on
    tensors, so it applies to dense tensors and gathered sparse rows;
  * ``serve_weights(param, slots)`` / ``serve_weights_np`` — the
    *inference* weights (FTRL derives ``w`` from ``z, n``);
  * ``update_rows(w, slots, grads, step, backend=...)`` — the master
    shard's batched row path on NumPy rows;
  * ``serve_slot_names`` — which slots the transform reads to build
    serve weights;
  * ``init_slots_tree(params)`` / ``update_tree(params, slots, grads,
    step)`` — the same over a nested dict/list parameter tree.
    ``update_tree`` updates params and slots IN PLACE (``update_``),
    where the reference's jitted train step donates its state.

All math is fp32, params cast back to their dtype. Ported so far:
``SGD``, ``Adam`` and ``FTRL``. ``get_optimizer`` raises ``KeyError``
naming the optimizers not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.tree import map_like
from repro_torch.kernels import ref


def _zeros_like(param):
    if isinstance(param, torch.Tensor):
        return torch.zeros(param.shape, dtype=torch.float32,
                           device=param.device)
    return np.zeros(np.shape(param), np.float32)


def _host(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


@dataclass(frozen=True)
class Optimizer:
    lr: float = 1e-3

    name: str = "base"
    serve_slot_names: tuple[str, ...] = ()

    def init_slots(self, param) -> dict:
        return {}

    def update(self, param, slots, grad, step):
        raise NotImplementedError

    def serve_weights(self, param, slots: dict):
        return param

    def serve_weights_np(self, param: np.ndarray, slots: dict) -> np.ndarray:
        """Host ``serve_weights`` for the sync plane's NumPy serve path.
        The default runs ``serve_weights`` on CPU tensors; optimizers with
        a NumPy mirror override it."""
        out = self.serve_weights(_host(param),
                                 {k: _host(v) for k, v in slots.items()})
        return out.numpy() if isinstance(out, torch.Tensor) else out

    def update_rows(self, w: np.ndarray, slots: dict, grads: np.ndarray,
                    step: int, *, backend: str = "numpy", device="cuda"):
        """One batched update over gathered (B, D) sparse rows — the
        MasterShard hot path. Returns NumPy ``(new_w, new_slots)``. The
        base implementation runs ``update`` on CPU tensors; optimizers
        with a kernel override this and dispatch on ``backend``."""
        new_w, new_slots = self.update(
            _host(w), {k: _host(v) for k, v in slots.items()}, _host(grads),
            step)
        return new_w.numpy(), {k: v.numpy() for k, v in new_slots.items()}

    def update_(self, param: torch.Tensor, slots: dict, grad: torch.Tensor,
                step: int) -> None:
        """``update`` written back into ``param`` and ``slots`` in place.
        Optimizers whose math runs in place override this (and derive
        ``update`` from it)."""
        new_p, new_s = self.update(param, slots, grad, step)
        param.copy_(new_p)
        for k, v in new_s.items():
            slots[k].copy_(v)

    # -- parameter trees -----------------------------------------------
    def init_slots_tree(self, params):
        """A slot dict per leaf of a nested dict/list param tree."""
        return map_like(self.init_slots, params)

    @torch.no_grad()
    def update_tree(self, params, slots, grads, step: int):
        """One step over a param tree, IN PLACE (the reference returns new
        trees; its train step donates the old ones). ``slots`` and
        ``grads`` have the params' structure (``slots`` a dict per leaf).
        Returns ``(params, slots)``, the trees passed in."""
        map_like(lambda p, s, g: self.update_(p, s, g, step), params, slots,
                 grads)
        return params, slots


def _pow_f32(base: float, n: int) -> np.float32:
    """``base ** n`` for an integer ``n >= 0`` in float32 by square and
    multiply — how the reference's jitted step raises a float to its
    int32 step counter (bit-equal to it)."""
    x, acc = np.float32(base), np.float32(1.0)
    while n:
        if n & 1:
            acc = np.float32(acc * x)
        x = np.float32(x * x)
        n >>= 1
    return acc


def _step_like(opt: Optimizer, param, slots: dict, grad, step: int):
    """``opt.update`` from its in-place ``update_``: on copies."""
    new_p = param.clone()
    new_s = {k: v.clone() for k, v in slots.items()}
    opt.update_(new_p, new_s, grad, step)
    return new_p, new_s


@dataclass(frozen=True)
class SGD(Optimizer):
    name: str = "sgd"

    def update(self, param, slots, grad, step):
        return _step_like(self, param, slots, grad, step)

    def update_(self, param, slots, grad, step):
        param.copy_(param.float() - grad.float() * self.lr)


@dataclass(frozen=True)
class Adam(Optimizer):
    """Adam in fp32 (the reference's math). The bias corrections ``1 -
    b ** t`` with ``t = step + 1`` are taken in float32 (``_pow_f32``),
    as the reference's jitted step takes them from its int32 step
    counter."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    name: str = "adam"

    def init_slots(self, param):
        return {"m": _zeros_like(param), "v": _zeros_like(param)}

    def update(self, param, slots, grad, step):
        return _step_like(self, param, slots, grad, step)

    def update_(self, param, slots, grad, step):
        g = grad.float()
        m, v = slots["m"], slots["v"]
        m.mul_(self.b1).add_(g * (1 - self.b1))
        v.mul_(self.b2).add_((g * (1 - self.b2)).mul_(g))
        t = int(step) + 1
        mhat = m / ref._f32(1 - _pow_f32(self.b1, t), m)
        vhat = v / ref._f32(1 - _pow_f32(self.b2, t), m)
        denom = vhat.sqrt_().add_(self.eps)
        param.copy_(param.float() - mhat.mul_(self.lr).div_(denom))


@dataclass(frozen=True)
class FTRL(Optimizer):
    """Follow-The-Regularized-Leader-Proximal (McMahan 2011). The training
    state is (z, n); the inference weight w is a pure function of them —
    the paper's canonical heterogeneous-parameter example."""

    alpha: float = 0.05
    beta: float = 1.0
    l1: float = 1.0
    l2: float = 1.0
    name: str = "ftrl"
    serve_slot_names: tuple[str, ...] = ("z", "n")

    def _params(self) -> dict:
        return {"alpha": self.alpha, "beta": self.beta, "l1": self.l1,
                "l2": self.l2}

    def init_slots(self, param):
        return {"z": _zeros_like(param), "n": _zeros_like(param)}

    def weights_from(self, z: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
        return ref.ftrl_weights(z, n, **self._params())

    def update(self, param, slots, grad, step):
        z_new, n_new, new_w = ref.ftrl_row_update(
            slots["z"], slots["n"], grad, **self._params())
        return new_w.to(param.dtype), {"z": z_new, "n": n_new}

    def serve_weights(self, param, slots):
        return self.weights_from(slots["z"], slots["n"]).to(param.dtype)

    def serve_weights_np(self, param, slots):
        return self._np_weights(
            np.asarray(slots["z"]), np.asarray(slots["n"])).astype(
            param.dtype, copy=False)

    def _np_weights(self, z: np.ndarray, n: np.ndarray) -> np.ndarray:
        # in-place ops: this runs inside the pusher's cache-blocked encode
        # tiles, where temporaries are the difference between staying in
        # L2 and spilling. The op order is the kernel's and ref.py's.
        denom = np.sqrt(n)
        denom += self.beta
        denom /= self.alpha
        denom += self.l2
        w = np.sign(z)
        w *= self.l1
        w -= z
        w /= denom
        return np.where(np.abs(z) > self.l1, w, np.float32(0.0)).astype(
            np.float32, copy=False)

    def update_rows(self, w, slots, grads, step, *, backend: str = "numpy",
                    device="cuda"):
        """Batched FTRL row update on NumPy rows. ``"torch"`` runs the
        ``ftrl_row_update`` kernel on ``device`` (its plain version on
        ``"cpu"``); ``"numpy"`` is the vectorized host route. Both give
        the same bits."""
        if backend == "torch":
            from repro_torch.core.ps import resolve_device
            dev = resolve_device(device)
            from repro_torch.kernels import ops
            up = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
                dev, copy=True) for a in (slots["z"], slots["n"], grads)]
            z_new, n_new, w_new = ops.ftrl_row_update(*up, **self._params())
            return w_new.cpu().numpy(), {"z": z_new.cpu().numpy(),
                                         "n": n_new.cpu().numpy()}
        if backend != "numpy":
            raise ValueError(f"backend must be 'numpy' or 'torch', got "
                             f"{backend!r}")
        g = np.asarray(grads, np.float32)
        z = np.asarray(slots["z"], np.float32)
        n = np.asarray(slots["n"], np.float32)
        w_old = self._np_weights(z, n)
        n_new = n + g * g
        sigma = (np.sqrt(n_new) - np.sqrt(n)) / self.alpha
        z_new = z + g - sigma * w_old
        return self._np_weights(z_new, n_new), {"z": z_new, "n": n_new}


_OPTIMIZERS = {"sgd": SGD, "adam": Adam, "ftrl": FTRL}
# the reference's other optimizers, not ported yet
_NOT_PORTED = ("adafactor", "adagrad", "momentum")


def get_optimizer(name: str, **kw) -> Optimizer:
    if name in _NOT_PORTED:
        raise KeyError(f"optimizer {name!r} is not ported yet (not ported: "
                       f"{', '.join(_NOT_PORTED)}; ported: "
                       f"{', '.join(sorted(_OPTIMIZERS))})")
    if name not in _OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}: {sorted(_OPTIMIZERS)}")
    return _OPTIMIZERS[name](**kw)
