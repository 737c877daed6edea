"""LM training: ``TrainState``, the loss and the train-step factory — the
counterpart of the reference's ``training/trainer.py``.

``make_train_step`` builds the step for a dense ``ModelConfig``; batches
are ``{"tokens": (B, S) integer}``. Labels are the next-token shift of
``tokens``. The step returns the metrics *before* the update is applied
(progressive validation, paper §4.3.1) alongside the updated state.

Where the reference differentiates its loss with ``jax.value_and_grad``,
the port runs ``torch.autograd``: the token gather's gradient goes
through the ``embedding_scatter_add`` kernel (``models.common``),
attention's forward through ``flash_attention`` (``models.attention``).
PyTorch runs eagerly, so the step is a plain function (the reference
jits it), and the optimizer updates params and slots IN PLACE where the
reference's jitted step donates its state: the ``TrainState`` passed in
shares its tensors with the one returned.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree
from repro_torch.models import forward, head_logits, init_params
from repro_torch.models import lm_head_weights
from repro_torch.optim import Optimizer, get_optimizer


class TrainState(NamedTuple):
    params: dict
    slots: dict
    step: int


def init_train_state(cfg: ModelConfig, gen: torch.Generator,
                     optimizer: Optional[Optimizer] = None) -> TrainState:
    """Random params drawn from ``gen`` (on its device), zero optimizer
    slots, step 0."""
    params = init_params(cfg, gen)
    opt = optimizer or get_optimizer(cfg.optimizer)
    return TrainState(params=params, slots=opt.init_slots_tree(params),
                      step=0)


def _ce_chunk(h_c: torch.Tensor, head: torch.Tensor, t_c: torch.Tensor,
              cfg: ModelConfig):
    """(sum of the NLL over valid targets, number of valid targets) for
    one chunk; targets < 0 are padding."""
    logits = head_logits(head, cfg, h_c).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, t_c.clamp_min(0).long()[..., None])[..., 0]
    valid = (t_c >= 0).float()
    return (nll * valid).sum(), valid.sum()


def _chunked_ce(hidden: torch.Tensor, head: torch.Tensor,
                targets: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Cross-entropy over S-chunks of ``cfg.loss_chunk`` positions: one
    chunk's fp32 logits at a time, each chunk recomputed in the backward
    (``torch.utils.checkpoint``, the reference's per-chunk
    ``jax.checkpoint``), so the (B, S, V) logits never exist whole."""
    s = hidden.shape[1]
    chunk = cfg.loss_chunk
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, s + pad, chunk):
        args = (hidden[:, c:c + chunk], head, targets[:, c:c + chunk], cfg)
        if torch.is_grad_enabled():
            nll, valid = checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            nll, valid = _ce_chunk(*args)
        total = total + nll
        count = count + valid
    return total / count.clamp_min(1.0)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict,
            aux_weight: float = 0.01):
    """``(loss, metrics)`` of next-token prediction on ``batch["tokens"]``.
    With ``cfg.loss_chunk`` the CE runs chunk by chunk on the hidden
    states; otherwise on the whole logits, ``log_softmax`` in fp32."""
    tokens = batch["tokens"]
    targets = tokens[:, 1:]
    if cfg.loss_chunk:
        hidden, metrics = forward(params, cfg, tokens,
                                  enc_context=batch.get("enc_context"),
                                  return_hidden=True)
        ce = _chunked_ce(hidden[:, :-1], lm_head_weights(params, cfg),
                         targets, cfg)
    else:
        logits, metrics = forward(params, cfg, tokens,
                                  enc_context=batch.get("enc_context"))
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        del logits
        nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
        ce = nll.mean()
    loss = ce + aux_weight * metrics["moe_aux"]
    return loss, {"loss": loss, "ce": ce, "ppl_log": ce,
                  "moe_aux": metrics["moe_aux"]}


def loss_and_grads(params: dict, cfg: ModelConfig, batch: dict,
                   aux_weight: float = 0.01):
    """``jax.value_and_grad(loss_fn, has_aux=True)``'s counterpart:
    ``(loss, metrics, grads)`` with ``grads`` of the params' structure.
    Marks every param leaf as requiring grad."""
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(params, cfg, batch, aux_weight)
        grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree.unflatten_like(params, list(grads))


def make_train_step(cfg: ModelConfig, optimizer: Optional[Optimizer] = None,
                    aux_weight: float = 0.01):
    """``train_step(state, batch) -> (state, metrics)``: loss and grads,
    then the optimizer's in-place update of params and slots; the metrics
    (``loss``, ``ce``, ``ppl_log``, ``moe_aux``) are pre-update."""
    opt = optimizer or get_optimizer(cfg.optimizer)

    def train_step(state: TrainState, batch: dict):
        _, metrics, grads = loss_and_grads(state.params, cfg, batch,
                                           aux_weight)
        params, slots = opt.update_tree(state.params, state.slots, grads,
                                        state.step)
        return TrainState(params=params, slots=slots,
                          step=state.step + 1), metrics

    return train_step
