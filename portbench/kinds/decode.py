"""Greedy decode of a large live batch through one ``ServeDriver``, with
hot swaps: a closed loop, one step for every sequence at a time.

Set-up makes two weight sets from the seed, a ``ServeDriver`` with a
``cache_len``-row cache in ``cache_dtype``, and fills every layer's K
and V rows from the seed. Sequence b starts at a position from an evenly
spaced set over ``positions`` (the same set for every seed, assigned in
an order drawn from it) with a Zipf id from the seed. Every step feeds
each sequence its last served token; every ``swap_every`` steps of the
stream, ``hot_swap`` installs the other weight set first (WeiPS's
deployment while serving). A step's gap runs from its start (the swap
included) to the read-back of its tokens, inside ``ServeDriver.step``.

The check: the longest sequence and others drawn from the seed. The
reference runs each over the seeded rows below its start and the tokens
it was fed, each step under the weight set of that step, and reads by
how much each served token's logit lies below its best.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench import harness
from portbench import trace as tr
from portbench import weights
from portbench.program import port_config
from portbench.reference.common import exact_float32


class Cell:
    kind = "decode"

    def __init__(self, ctx):
        self.ctx = ctx
        self.spec, self.mix = ctx.spec, ctx.mix
        self.batch = self.mix["batch"]
        self.attempted = self.failed = 0
        self.trace = None
        self.stats: dict = {}
        self.gaps: list = []
        lo, hi = self.mix["positions"]
        order = np.random.default_rng(weights.leaf_seed(
            ctx.seed, "decode/positions")).permutation(self.batch)
        self.start = (lo + (hi - lo) * np.arange(self.batch)
                      // self.batch)[order]
        self.first = weights.zipf_ids(ctx.seed, "decode/first", self.batch,
                                      self.spec["vocab_size"],
                                      self.mix["zipf_exponent"])

    def kv_shape(self) -> tuple:
        return (self.batch, self.mix["cache_len"],
                self.spec["num_key_value_heads"], self.spec["head_dim"])

    def setup(self) -> None:
        import torch
        from repro_torch.serving.predictor import ServeDriver
        dev, spec = self.ctx.device, self.spec
        self.sets = [weights.make_params(spec, self.ctx.seed, dev,
                                         spec["torch_dtype"], tag=t)
                     for t in ("A/", "B/")]
        self.ctx.log("cache")
        self.driver = ServeDriver(
            cfg=port_config(spec), params=self.sets[0], batch=self.batch,
            max_len=self.mix["cache_len"],
            cache_dtype=getattr(torch, self.mix["cache_dtype"]), device=dev)
        entry = self.driver.cache["segments"][0]["pos0"]
        for layer in range(spec["num_hidden_layers"]):
            for which in ("k", "v"):
                entry[which][layer].copy_(weights.cache_rows(
                    self.ctx.seed, layer, which, self.kv_shape(), dev,
                    entry[which].dtype))
        self.driver.pos = torch.as_tensor(self.start, dtype=torch.int32,
                                          device=dev)
        self.tok = torch.as_tensor(self.first, dtype=torch.int32,
                                   device=dev)[:, None]
        self.ctx.log("warm-up steps")
        self.t = 0
        for _ in range(self.mix["warmup_steps"]):
            self._step()

    def _step(self) -> float:
        """One stream step; returns its gap in seconds."""
        import torch
        t0 = time.perf_counter()
        every = self.mix["swap_every"]
        if self.t and self.t % every == 0:
            with tr.span("hot_swap"):
                self.driver.hot_swap(self.sets[(self.t // every) % 2])
        with torch.no_grad(), tr.span("ServeDriver.step"):
            self.tok = self.driver.step(self.tok)
        gap = time.perf_counter() - t0
        self.t += 1
        self.attempted += self.batch
        self.failed += int((self.driver.generated[-1]
                            >= self.spec["vocab_size"]).sum())
        return gap

    def lengths(self, t: int) -> np.ndarray:
        """Each sequence's attended rows at stream step ``t``."""
        return self.start + t + 1

    def window(self, seconds: float) -> None:
        fam = self.ctx.family
        t0 = time.perf_counter()
        steps, flops = 0, 0.0
        while time.perf_counter() - t0 < seconds:
            if self.lengths(self.t).max() > self.mix["cache_len"]:
                raise RuntimeError("the window outran the cache's rows: "
                                   "lower the positions or the seconds")
            flops += fam.decode_flops(self.spec, self.lengths(self.t))
            self.gaps.append(self._step())
            steps += 1
        self.stats = {"steps": steps, "flops": flops,
                      "seconds": time.perf_counter() - t0}
        self.ctx.log(harness.spread_line("window steps", self.gaps))

    def traced(self) -> None:
        k = self.mix["trace_items"]
        self.trace_first = self.t
        _, self.trace = tr.record(lambda: [self._step() for _ in range(k)],
                                  self.ctx.device)
        self.trace_steps = k

    def release(self) -> None:
        import torch
        self.generated = np.stack(self.driver.generated, axis=1)  # (B, n)
        del self.driver, self.sets, self.tok
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def end_to_end(self, name: str):
        if name == "tpot_p95_ms" and self.gaps:
            return harness.percentile(self.gaps, 95) * 1e3
        return None

    def checked_sequences(self) -> list:
        """The longest sequence, then others drawn from the seed."""
        longest = int(np.argmax(self.start))
        rest = [b for b in range(self.batch) if b != longest]
        rng = np.random.default_rng(weights.leaf_seed(self.ctx.seed,
                                                      "decode/checked"))
        k = self.mix["checked_sequences"] - 1
        return [longest] + sorted(int(b) for b in rng.choice(rest, k,
                                                              replace=False))

    def fed_and_served(self, b: int) -> tuple:
        served = self.generated[b]
        fed = np.concatenate([[self.first[b]], served[:-1]])
        return fed, served

    def reference_logits(self, seqs: list, prec: str) -> dict:
        """``{b: (n, V) logits}`` of the reference for the sequences."""
        import torch
        fam, dev, spec = self.ctx.family, self.ctx.device, self.spec
        with exact_float32():
            sets = [weights.make_params(spec, self.ctx.seed, dev, "float32",
                                        tag=t) for t in ("A/", "B/")]
            prefix = {b: [] for b in seqs}
            for layer in range(spec["num_hidden_layers"]):
                rows = {w: weights.cache_rows(self.ctx.seed, layer, w,
                                              self.kv_shape(), dev,
                                              torch.float32)
                        for w in ("k", "v")}
                for b in seqs:
                    n = int(self.start[b])
                    prefix[b].append((rows["k"][b, :n].clone(),
                                      rows["v"][b, :n].clone()))
                del rows
            out = {}
            for b in seqs:
                fed, _ = self.fed_and_served(b)
                out[b] = fam.decode_logits(
                    sets, spec, prefix.pop(b),
                    torch.as_tensor(fed, dtype=torch.long, device=dev),
                    int(self.start[b]), self.mix["swap_every"], prec)
            return out

    def _gaps(self, prec=None) -> dict:
        """The widest gap of the checked sequences' served tokens (with
        ``prec``: of the tokens that reference puts first at each step of
        the same fed tokens) under the float32 reference."""
        import torch
        seqs = self.checked_sequences()
        if not hasattr(self, "_ref"):
            self._ref = self.reference_logits(seqs, "float32")
        other = None if prec is None else self.reference_logits(seqs, prec)
        gaps = []
        for b in seqs:
            lg = self._ref[b]
            served = (torch.as_tensor(self.fed_and_served(b)[1],
                                      dtype=torch.long, device=lg.device)
                      if other is None else other[b].argmax(-1))
            gaps.append(float((lg.max(-1).values
                               - lg.gather(-1, served[:, None])[:, 0]).max()))
        print(f"decode check{'' if prec is None else ' ' + prec}: sequences "
              f"{seqs}, {self.generated.shape[1]} tokens each, widest gap a "
              f"sequence {[round(g, 5) for g in gaps]}", file=sys.stderr)
        return {"token_gap": max(gaps)}

    def readings(self) -> dict:
        return self._gaps()

    def check(self) -> dict:
        return harness.limited(self.readings(), self.ctx.limits)

    def control(self) -> dict:
        """The numbers with the reference in fp8 in the program's
        place."""
        return self._gaps("fp8")
