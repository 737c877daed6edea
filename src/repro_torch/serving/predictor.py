"""LM serving: prefill and decode step factories and a batched greedy
driver with hot weight swap — the counterpart of the reference's
``serving/predictor.py``.

``serve_step`` consumes *serve params* (in the reference, the slave-side
state its ModelSyncEngine produces) and a KV cache, and appends ONE token
per sequence. ``ServeDriver.hot_swap`` installs new serve params between
steps without dropping in-flight sequences, because the cache layout does
not depend on the weights — the paper's second-level deployment applied
to an LM.

PyTorch runs eagerly, so the factories return plain functions (the
reference jits them). The reference's serve step donates its cache
(``donate_argnums=(1,)``); the port's writes the new K/V rows into the
cache IN PLACE and returns it.

A prefill step runs inside an ``obs.trace`` span with its device
interval (``prefill.step``); a driver's decode step inside
``decode.step``, split into ``decode.dispatch`` (entry to the argmax)
and ``decode.readback`` (the tokens' copy to the host, which waits for
the device). They record only under a profiler or a tracer turned on.
``hot_swap`` assigns a dict and has no span.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ps import resolve_device
from repro_torch.models import decode_step, forward, init_cache
from repro_torch.obs import trace as obs_trace


def make_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(params: dict, cache: dict, tokens: torch.Tensor,
                   pos: torch.Tensor):
        """tokens (B, 1) int; pos (B,) int -> (logits (B, V), cache), the
        cache updated in place."""
        return decode_step(params, cfg, cache, tokens, pos)

    return serve_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params: dict, batch: dict) -> torch.Tensor:
        """``batch["tokens"]`` (B, S) -> logits (B, S, V)."""
        with obs_trace.get_tracer().span("prefill.step", device=True):
            logits, _ = forward(params, cfg, batch["tokens"],
                                enc_context=batch.get("enc_context"))
        return logits

    return prefill_step


@dataclass
class ServeDriver:
    """Batched greedy-decode driver with hot weight swap. The cache and
    the positions live on ``device`` (default the card; raises without
    one); ``params`` must be there too."""

    cfg: ModelConfig
    params: dict
    batch: int
    max_len: int
    cache_dtype: Any = torch.float32
    step_fn: Optional[Callable] = None
    generated: list = field(default_factory=list)
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.step_fn = self.step_fn or make_serve_step(self.cfg)
        self.cache = init_cache(self.cfg, self.batch, self.max_len,
                                dtype=self.cache_dtype, device=self.device)
        self.pos = torch.zeros((self.batch,), dtype=torch.int32,
                               device=self.device)

    def hot_swap(self, new_params: dict) -> None:
        """Second-level deployment: swap weights between decode steps.
        The cache stays as it is: a model with context keeps the cross
        cache computed from the old weights (``precompute_cross_cache``),
        as the reference's driver does, until the caller fills it
        again."""
        self.params = new_params

    def step(self, tokens: torch.Tensor) -> torch.Tensor:
        tr = obs_trace.get_tracer()
        with tr.span("decode.step"):
            with tr.span("decode.dispatch"):
                logits, self.cache = self.step_fn(self.params, self.cache,
                                                  tokens, self.pos)
                self.pos = self.pos + 1
                nxt = logits.argmax(dim=-1).to(torch.int32)
            with tr.span("decode.readback"):
                out = nxt.cpu()
            self.generated.append(out.numpy())
        return nxt[:, None]

    def generate(self, prompt_token: torch.Tensor, steps: int) -> np.ndarray:
        # fresh accumulator per call: a second generate returns only its
        # own tokens (the cache and positions carry over, so a hot_swap
        # mid-stream still works)
        self.generated = []
        tok = prompt_token
        for _ in range(steps):
            tok = self.step(tok)
        return np.stack(self.generated, axis=1)
