"""Online training on a packed stream: a closed loop, one step in flight.

Each step takes a fresh (batch, seq) block of Zipf token ids drawn from
the seed and runs the port's ``make_train_step`` (loss and gradients,
then the optimizer's in-place update) on one ``TrainState`` built from
the benchmark's weights; it ends, as ``launch/train.run`` does, in a
device sync and the read-back of its pre-update loss (progressive
validation).

Set-up runs the stream's first ``checked_steps`` steps through that same
call and keeps, on the host, what the check compares: each step's loss,
the first gradient as the optimizer got it (its first moment after one
step, ``m / (1 - b1)``), and the weights after the steps. The window then
continues the stream. The check follows those steps with the plain
reference in float32 from the same weights and batches, its weights
held in the configuration's dtype after each update as the program's
are, and measures per leaf how far the program's gradient and change lie
from the reference's.
"""

from __future__ import annotations

import math
import statistics
import sys
import time

import numpy as np

from portbench import harness
from portbench import trace as tr
from portbench import weights
from portbench.program import port_config
from portbench.reference.common import adam_, exact_float32
from portbench.reference.tree import paths

# a leaf whose reference gradient is under this share of the median
# leaf's is moved by round-off alone under Adam: left out of the change
FLAT_GRAD = 1e-3


class Cell:
    kind = "train"

    def __init__(self, ctx):
        self.ctx = ctx
        self.spec, self.mix = ctx.spec, ctx.mix
        self.batch, self.seq = self.mix["batch"], self.mix["seq"]
        self.attempted = self.failed = 0
        self.trace = None
        self.stats: dict = {}

    def tokens(self, i: int) -> np.ndarray:
        """Batch ``i`` of the stream: (batch, seq) int64 ids."""
        ids = weights.zipf_ids(self.ctx.seed, f"train/{i}",
                               self.batch * self.seq,
                               self.spec["vocab_size"],
                               self.mix["zipf_exponent"])
        return ids.reshape(self.batch, self.seq)

    def setup(self) -> None:
        from repro_torch.optim import get_optimizer
        from repro_torch.training import TrainState, make_train_step
        o = self.mix["optimizer"]
        opt = get_optimizer(o["name"], lr=o["lr"], b1=o["b1"], b2=o["b2"],
                            eps=o["eps"])
        self.ctx.log("weights")
        params = weights.make_params(self.spec, self.ctx.seed,
                                     self.ctx.device,
                                     self.spec["torch_dtype"])
        self.state = TrainState(params=params,
                                slots=opt.init_slots_tree(params), step=0)
        self.step_fn = make_train_step(port_config(self.spec), optimizer=opt)
        self.ctx.log("first steps")
        self.next = 0
        self.losses = []
        for i in range(self.mix["checked_steps"]):
            self.losses.append(self._step())
            self.ctx.log(f"step {i} done")
            if i == 0:
                self.first_grads = self._first_grads()
        self.final = {p: t.detach().to("cpu", copy=True)
                      for p, t in paths(self.state.params)}

    def _step(self) -> float:
        import torch
        dev = self.ctx.device
        ids = torch.from_numpy(self.tokens(self.next)).to(dev)
        self.next += 1
        with tr.span("train_step"):
            self.state, metrics = self.step_fn(self.state, {"tokens": ids})
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return float(metrics["loss"])

    def _first_grads(self) -> dict:
        """Each leaf's gradient as the optimizer got it, from its first
        moment after one step, on the host."""
        b1 = self.mix["optimizer"]["b1"]
        slots = dict(paths(self.state.slots))
        return {p: (slots[f"{p}/m"].float() / (1 - b1)).cpu()
                for p, _ in paths(self.state.params)}

    def _start(self, path: str):
        """A leaf's seeded weights, in float32 on the device."""
        return weights.make_leaf(self.spec, self.ctx.seed, path,
                                 self.ctx.device, "float32")

    def window(self, seconds: float) -> None:
        t0 = prev = time.perf_counter()
        steps, last, times = 0, t0, []
        while time.perf_counter() - t0 < seconds:
            loss = self._step()
            t = time.perf_counter()
            times.append(t - prev)
            prev = t
            self.attempted += 1
            self.failed += not math.isfinite(loss)
            if t - t0 > seconds:
                break
            steps, last = steps + 1, t
        self.stats = {"steps": steps, "seconds": last - t0,
                      "flops": steps * self.ctx.family.train_flops(
                          self.spec, self.batch, self.seq)}
        self.ctx.log(harness.spread_line("window steps", times))

    def traced(self) -> None:
        n = self.mix["trace_items"]
        _, self.trace = tr.record(lambda: [self._step() for _ in range(n)],
                                  self.ctx.device)

    def release(self) -> None:
        import torch
        del self.state, self.step_fn
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def end_to_end(self, name: str):
        if name == "train_tokens_per_s" and self.stats.get("seconds"):
            return self.stats["steps"] * self.batch * self.seq \
                / self.stats["seconds"]
        return None

    # -- the check ------------------------------------------------------
    def reference_run(self, prec: str, rows: int = None) -> dict:
        """The reference over the checked steps from the seed's weights,
        computed in ``prec`` with its weights held in the configuration's
        dtype after each update: each step's loss, the first step's
        gradient and each leaf's change after the steps (on the device,
        float32). With ``rows``, each step's loss is the mean over the
        batch's first ``rows`` rows only (the half-batch fault put in the
        program's place)."""
        import torch
        fam, dev = self.ctx.family, self.ctx.device
        opt = self.mix["optimizer"]
        held = weights.leaf_specs(self.spec)
        with exact_float32():
            params = weights.make_params(self.spec, self.ctx.seed, dev,
                                         "float32")
            leaves = dict(paths(params))
            m = {p: torch.zeros_like(t) for p, t in leaves.items()}
            v = {p: torch.zeros_like(t) for p, t in leaves.items()}
            losses, first = [], None
            for i in range(self.mix["checked_steps"]):
                ids = torch.from_numpy(self.tokens(i)[:rows]).to(dev)
                loss, grads = fam.loss_and_grads(params, self.spec, ids, prec)
                losses.append(loss)
                with torch.no_grad():
                    for p, t in leaves.items():
                        adam_(t, grads[p], m[p], v[p], i, opt,
                              None if held[p][3] else self.spec["torch_dtype"])
                if first is None:
                    first = grads
                del grads
            del m, v
            for p, t in leaves.items():
                t.sub_(self._start(p))
        return {"losses": losses, "grads": first, "change": leaves}

    def _reference(self) -> dict:
        if not hasattr(self, "_ref"):
            self._ref = self.reference_run("float32")
        return self._ref

    def _program(self) -> dict:
        """The program's kept readings, as the check reads them: each
        leaf brought to the device in float32."""
        dev = self.ctx.device
        return {"losses": self.losses,
                "grads": _Leaves(lambda p: self.first_grads[p].to(dev)),
                "change": _Leaves(lambda p: self.final[p].to(dev).float()
                                  - self._start(p))}

    def readings(self) -> dict:
        """Every number the check reads from the program, compared or
        not."""
        return compare(self._program(), self._reference())

    def check(self) -> dict:
        return harness.limited(self.readings(), self.ctx.limits)

    def control(self) -> dict:
        """The numbers with the reference in fp8 in the program's
        place."""
        return compare(self.reference_run("fp8"), self._reference())

    def faults(self) -> dict:
        """The numbers of each fault a training cell can have, put in the
        program's place: ``{fault: readings}``. The reference on the
        first half of each batch; the program's own readings with each
        step's loss 1% off where the step produces it; a state left
        unchanged (no first moment, no change)."""
        import torch
        ref = self._reference()
        zero = _Leaves(lambda p: torch.zeros_like(ref["grads"][p]))
        return {"half_batch": compare(self.reference_run(
                    "float32", rows=self.batch // 2), ref),
                "altered": compare({**self._program(), "losses": [
                    x * 1.01 for x in self.losses]}, ref),
                "unchanged": compare({"losses": self.losses, "grads": zero,
                                      "change": zero}, ref)}


class _Leaves:
    """A leaf by its path, made when it is read."""

    def __init__(self, make):
        self.make = make

    def __getitem__(self, path: str):
        return self.make(path)


def _distances(got, ref: dict, keep: list) -> dict:
    """Each kept leaf's distance ``|got - ref|``, against the larger of
    the reference's norm of that leaf and of the median leaf."""
    import torch
    norm = {p: float(torch.linalg.vector_norm(ref[p])) for p in keep}
    floor = statistics.median(norm.values())
    return {p: float(torch.linalg.vector_norm(got[p] - ref[p]))
            / max(norm[p], floor, 1e-30) for p in keep}


def compare(got: dict, ref: dict) -> dict:
    """The numbers the check reads: the first step's loss, relative (the
    later steps' losses swing with rounding at this learning rate,
    PERF.md); per leaf the distance of the first gradient, by the worst
    leaf and by the median leaf, and of the change after the steps, by
    the worst leaf whose reference gradient is not flat."""
    import torch
    first = got["losses"][0], ref["losses"][0]
    every = max(abs(a - b) / abs(b)
                for a, b in zip(got["losses"], ref["losses"]))
    rg = ref["grads"]
    gn = {p: float(torch.linalg.vector_norm(g)) for p, g in rg.items()}
    floor = statistics.median(gn.values())
    moving = [p for p in gn if gn[p] >= FLAT_GRAD * floor]
    grad = _distances(got["grads"], rg, list(rg))
    change = _distances(got["change"], ref["change"], moving)
    grad_leaf = max(grad, key=grad.get)
    change_leaf = max(change, key=change.get)
    print(f"train check: losses {got['losses']} vs {ref['losses']} (every "
          f"step's gap {every!r}); worst gradient leaf {grad_leaf}, worst "
          f"change leaf {change_leaf}; flat leaves left out of the change: "
          f"{sorted(set(gn) - set(moving))}", file=sys.stderr)
    return {"loss_gap": abs(first[0] - first[1]) / abs(first[1]),
            "grad_dist": grad[grad_leaf],
            "grad_median_dist": statistics.median(grad.values()),
            "change_dist": change[change_leaf]}
