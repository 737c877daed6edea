"""Prompt batches: a closed loop, one batch in flight, each prompt's first
token served.

Batch i holds ``batch`` prompts of one length; every cycle of batches
holds each length of ``cycle`` as many times as it says, in an order
drawn from the seed, so every seed runs the same mix. A batch runs the
port's ``make_prefill_step`` under ``torch.inference_mode()`` and reads
back each prompt's first token, the argmax of the logits at its last
position; a request's time to first token runs from its batch's
dispatch (before the ids go to the card) to that read-back.

The check: a sample of the window's requests drawn from the seed, one
of each length of the first cycle (so the longest is in it). For those
the served token at every position (the argmax of the scoring logits)
is kept; the reference runs each prompt once and reads by how much each
served token's logit lies below its best.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench import harness
from portbench import trace as tr
from portbench import weights
from portbench.program import port_config
from portbench.reference.common import (exact_float32, prompt_argmax,
                                         prompt_argmax_gaps)


class Cell:
    kind = "prefill"

    def __init__(self, ctx):
        self.ctx = ctx
        self.spec, self.mix = ctx.spec, ctx.mix
        self.batch = self.mix["batch"]
        self.cycle = [n for n, count in self.mix["cycle"]
                      for _ in range(count)]
        self.attempted = self.failed = 0
        self.trace = None
        self.stats: dict = {}
        self.ttft: list = []
        self.served: dict = {}          # (batch i, row) -> (S,) argmax

    def length(self, i: int) -> int:
        c, k = divmod(i, len(self.cycle))
        perm = np.random.default_rng(weights.leaf_seed(
            self.ctx.seed, f"prefill/cycle/{c}")).permutation(len(self.cycle))
        return self.cycle[perm[k]]

    def tokens(self, i: int) -> np.ndarray:
        n = self.length(i)
        return weights.zipf_ids(self.ctx.seed, f"prefill/{i}",
                                self.batch * n, self.spec["vocab_size"],
                                self.mix["zipf_exponent"]).reshape(
                                    self.batch, n)

    def _sample(self) -> dict:
        """``{batch i: row}``: the first batch of each length in the first
        cycle, a row of it drawn from the seed."""
        rng = np.random.default_rng(weights.leaf_seed(self.ctx.seed,
                                                      "prefill/checked"))
        first: dict = {}
        for i in range(len(self.cycle)):
            first.setdefault(self.length(i), i)
        picked = sorted(first.values(), key=self.length,
                        reverse=True)[:self.mix["checked_requests"]]
        return {i: int(rng.integers(self.batch)) for i in picked}

    def setup(self) -> None:
        from repro_torch.serving.predictor import make_prefill_step
        self.params = weights.make_params(self.spec, self.ctx.seed,
                                          self.ctx.device,
                                          self.spec["torch_dtype"])
        self.step_fn = make_prefill_step(port_config(self.spec))
        self.ctx.log("warm-up batches")
        self.checked = self._sample()
        self.next = 0
        for n in sorted(set(self.cycle)):         # warm each length once
            warm = weights.zipf_ids(self.ctx.seed, f"prefill/warm/{n}",
                                    self.batch * n, self.spec["vocab_size"],
                                    self.mix["zipf_exponent"])
            self._serve(warm.reshape(self.batch, n), keep=None)

    def _serve(self, ids: np.ndarray, keep):
        """One batch; returns its time to first token. ``keep``: a row
        whose served token at every position is returned too."""
        import torch
        dev = self.ctx.device
        t = time.perf_counter()
        with torch.inference_mode(), tr.span("prefill_step"):
            logits = self.step_fn(self.params,
                                  {"tokens": torch.from_numpy(ids).to(dev)})
            first = logits[:, -1].argmax(-1).cpu().numpy()
        ttft = time.perf_counter() - t
        bad = int((first >= self.spec["vocab_size"]).sum())
        row = None if keep is None else logits[keep].argmax(-1).cpu()
        return ttft, bad, row

    def _next_batch(self) -> float:
        i = self.next
        self.next += 1
        ttft, bad, row = self._serve(self.tokens(i), self.checked.get(i))
        if row is not None:
            self.served[i] = row
        self.attempted += self.batch
        self.failed += bad
        return ttft

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        batches, flops = 0, 0.0
        while time.perf_counter() - t0 < seconds:
            n = self.length(self.next)
            self.ttft.extend([self._next_batch()] * self.batch)
            batches += 1
            flops += self.ctx.family.forward_flops(self.spec, self.batch,
                                                   n)
        self.stats = {"batches": batches, "flops": flops,
                      "seconds": time.perf_counter() - t0}
        self.ctx.log(harness.spread_line("window requests", self.ttft))

    def traced(self) -> None:
        k = self.mix["trace_items"]
        first = self.next
        _, self.trace = tr.record(
            lambda: [self._next_batch() for _ in range(k)], self.ctx.device)
        self.trace_lengths = [self.length(i) for i in range(first, first + k)]

    def release(self) -> None:
        import torch
        del self.params, self.step_fn
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def end_to_end(self, name: str):
        if name == "ttft_p95_ms" and self.ttft:
            return harness.percentile(self.ttft, 95) * 1e3
        return None

    def checked_requests(self) -> list:
        """``[(tokens (S,), served (S,))]`` of the sampled requests that
        the window finished."""
        return [(self.tokens(i)[r], self.served[i].numpy())
                for i, r in sorted(self.checked.items()) if i in self.served]

    def _gaps(self, prec=None) -> dict:
        """The widest gap of the checked requests' served tokens (with
        ``prec``: of the tokens that reference puts first) under the
        float32 reference."""
        import torch
        fam, dev = self.ctx.family, self.ctx.device
        done = self.checked_requests()
        if len(done) < len(self.checked):
            print(f"prefill check: {len(done)} of {len(self.checked)} "
                  f"sampled requests finished", file=sys.stderr)
            return {"token_gap": float("inf")}
        with exact_float32():
            params = weights.make_params(self.spec, self.ctx.seed, dev,
                                         "float32")
            gaps = []
            for toks, served in done:
                toks = torch.from_numpy(toks).to(dev)
                served = (torch.from_numpy(served).to(dev) if prec is None
                          else prompt_argmax(fam, params, self.spec, toks,
                                             prec))
                gaps.append(float(prompt_argmax_gaps(
                    fam, params, self.spec, toks, served).max()))
        print(f"prefill check{'' if prec is None else ' ' + prec}: widest "
              f"gap a request {[round(g, 5) for g in gaps]} at lengths "
              f"{[len(t) for t, _ in done]}", file=sys.stderr)
        return {"token_gap": max(gaps)}

    def readings(self) -> dict:
        return self._gaps()

    def check(self) -> dict:
        return harness.limited(self.readings(), self.ctx.limits)

    def control(self) -> dict:
        """The numbers with the reference in fp8 in the program's
        place."""
        return self._gaps("fp8")
