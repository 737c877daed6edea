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

On a card the driver replays its decode step from one CUDA graph, so a
step costs the host one launch instead of one a kernel. The first step
with given weights, cache and step function runs eagerly (it builds the
kernels and warms cuBLAS and the allocator); the second captures the
step and its argmax into a graph in the graph's own memory pool and
replays it (a capture records work without running it); every later
step copies its tokens into the driver's token buffer and replays. A
graph keeps the addresses it captured, so at the capture the driver
copies the weights into buffers of its own, in the caller's dtypes, and
from then on ``hot_swap`` copies new weights into them on the current
stream, in order with the next replay, and never writes into the
caller's tensors. ``pos`` is the driver's position buffer, advanced in
place; a tensor assigned to ``pos`` is copied into it at the next step.

The driver captures only where it can see that a replay does what the
eager step would: on a CUDA device, with the step function it built
itself (a caller's may do host work at every call, which a replay would
skip), weights and cache of plain tensors on that device (no
``DTensor``, fake or meta tensor, no dispatch mode), and room in free
memory for the copy of the weights. Otherwise it steps eagerly. Weights,
a cache or a step function other than those captured (a swap to a tree
of other shapes or dtypes, a cache assigned anew) drop the graph, and
the driver warms up and captures again.

A prefill step runs inside an ``obs.trace`` span with its device
interval (``prefill.step``); a driver's decode step inside
``decode.step``, split into ``decode.dispatch`` (entry to the argmax;
its ``graph`` attribute says how the step ran: ``eager``, ``capture``
or ``replay``) and ``decode.readback`` (the tokens' copy to the host,
which waits for the device). They record only under a profiler or a
tracer turned on. No Python runs inside a replay, so the model's
host-only spans of a decode step (``layer.mixer``, ``model.head``) fire
on eager and capturing steps only. ``hot_swap`` has no span.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ps import resolve_device
from repro_torch.kernels._build import direct
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
    one); ``params`` must be there too. On a card the decode step is
    replayed from a CUDA graph (module docstring)."""

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
        self._own_step = make_serve_step(self.cfg)
        self.step_fn = self.step_fn or self._own_step
        self.cache = init_cache(self.cfg, self.batch, self.max_len,
                                dtype=self.cache_dtype, device=self.device)
        self.pos = torch.zeros((self.batch,), dtype=torch.int32,
                               device=self.device)
        self._pos = self.pos            # the position buffer
        self._tokens = None             # the token buffer, from step 1
        # (graph, its argmax output, the (step_fn, params, cache) it
        # captured); the ids of the (step_fn, params, cache) last seen
        # without a graph, and how their next step runs
        self._graph: Optional[tuple] = None
        self._seen: Optional[tuple] = None
        self._next = "eager"

    def hot_swap(self, new_params: dict) -> None:
        """Second-level deployment: swap weights between decode steps.
        With a graph captured on the driver's weight buffers,
        ``new_params`` is copied into them where its tree, shapes, dtypes
        and device match; otherwise the driver takes ``new_params`` as
        they are. The cache stays as it is: a model with context keeps
        the cross cache computed from the old weights
        (``precompute_cross_cache``), as the reference's driver does,
        until the caller fills it again."""
        if self._graph is not None and self._graph[2][1] is self.params:
            new, spec = tree_flatten(new_params)
            own, own_spec = tree_flatten(self.params)
            if spec == own_spec and direct(*new) and all(
                    (n.shape, n.dtype, n.device) == (o.shape, o.dtype,
                                                     o.device)
                    for n, o in zip(new, own)):
                with torch.no_grad():
                    for o, n in zip(own, new):
                        o.copy_(n)
                return
        self.params = new_params
        self._seen = None

    def _mode(self) -> str:
        """How this step runs: ``eager``, ``capture`` or ``replay``, from
        what the driver observes of its step function, weights and cache.
        New ones take an eager step first."""
        inputs = (self.step_fn, self.params, self.cache)
        if self._graph is not None:
            if all(a is b for a, b in zip(self._graph[2], inputs)):
                return "replay"
            self._graph = None
        ids = tuple(map(id, inputs))
        if ids != self._seen:
            self._seen = ids
            self._next = "capture" if self._may_capture() else "eager"
            return "eager"
        if self._next == "capture" and not self._weights_fit():
            self._next = "eager"
        return self._next

    def _may_capture(self) -> bool:
        """Whether a replay would do what the eager step does: the
        driver's own step on plain tensors, all on the current card."""
        if self.device.type != "cuda" or self.step_fn is not self._own_step:
            return False
        leaves = tree_flatten((self.params, self.cache))[0]
        here = torch.device("cuda", torch.cuda.current_device())
        return self.device.index in (None, here.index) and direct(
            *leaves) and all(t.device == here for t in leaves)

    def _weights_fit(self) -> bool:
        """Whether a second copy of the weights fits in the card's free
        memory and the allocator's unused cache."""
        need = sum(t.numel() * t.element_size()
                   for t in tree_flatten(self.params)[0])
        free = torch.cuda.mem_get_info(self.device)[0]
        cached = torch.cuda.memory_reserved(self.device) \
            - torch.cuda.memory_allocated(self.device)
        return need <= free + cached

    def _step_body(self) -> torch.Tensor:
        """The step on the token and position buffers: the argmax tokens
        (B,) int32; the positions advanced in place."""
        logits, self.cache = self.step_fn(self.params, self.cache,
                                          self._tokens, self._pos)
        self._pos.add_(1)
        return logits.argmax(dim=-1).to(torch.int32)

    def _capture(self) -> None:
        """Copy the weights into the driver's buffers and capture the
        step on them into a graph (run by its first replay)."""
        with torch.inference_mode(False):   # buffers written in any mode
            self.params = tree_map(lambda t: t.detach().clone(),
                                   self.params)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._step_body()
        self._graph = (graph, out, (self.step_fn, self.params, self.cache))

    def _dispatch(self, tokens: torch.Tensor, mode: str) -> torch.Tensor:
        if self._tokens is None:
            with torch.inference_mode(False):
                self._tokens = tokens.to(self.device, copy=True)
        else:
            self._tokens.copy_(tokens)
        if self.pos is not self._pos:
            self._pos.copy_(self.pos)
            self.pos = self._pos
        if mode == "eager":
            return self._step_body()
        if mode == "capture":
            self._capture()
        graph, out, _ = self._graph
        graph.replay()
        return out

    def step(self, tokens: torch.Tensor) -> torch.Tensor:
        """One decode step for every sequence: tokens (B, 1) -> the next
        tokens (B, 1) int32 on the device (after a replay, a view of the
        graph's output, which the next step overwrites)."""
        tr = obs_trace.get_tracer()
        with tr.span("decode.step"):
            mode = self._mode()
            with tr.span("decode.dispatch", graph=mode):
                nxt = self._dispatch(tokens, mode)
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
