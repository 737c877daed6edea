"""The profiled slice of a ``--trace 1`` run: ``torch.profiler`` with
CUDA activity only (CUPTI's device records and runtime calls; recording
every host operator as well would slow a host-paced step by most of
itself) over a bounded number of work items after the window, reduced
to what the per-layer readers and the result line need.

- ``window_s``: the slice on the host's clock, from just before its
  first call to the device sync that ends it.
- ``busy_s``: the union of the device operations' intervals (kernels,
  copies and fills) in the slice.
- each kernel's device time and count, by a part of its name.
- ``breakdown``: the device operations that took most time, and the idle
  time between device operations summed by the operation the device
  waited for (what the host was launching; the slice's edges on their
  own line).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

SLICE_SPAN = "portbench.slice"
# the harness's own spans around the program's entry points
SPANS = (SLICE_SPAN, "train_step", "prefill_step", "ServeDriver.step",
         "hot_swap")


@contextmanager
def span(name: str):
    """A ``record_function`` span: what the profiler shows of a call into
    the program."""
    import torch
    with torch.profiler.record_function(name):
        yield


class Trace:
    """Device intervals of one profiled slice."""

    def __init__(self, device_ops: list, window_s: float):
        self.window_s = window_s
        self.device_ops = device_ops
        self.merged = _merge([(s, e) for s, e, _, _ in device_ops])
        self.t0, self.t1 = self.merged[0][0], self.merged[-1][1]
        self.busy_s = sum(e - s for s, e in self.merged) / 1e9

    def kernel_s(self, part: str) -> float:
        """Device seconds of the kernels whose name holds ``part``."""
        return sum(e - s for s, e, n, k in self.device_ops
                   if k and part in n) / 1e9

    def kernel_count(self, part: str = "") -> int:
        return sum(1 for _, _, n, k in self.device_ops if k and part in n)

    def breakdown(self) -> dict:
        by_op: dict = defaultdict(float)
        for s, e, n, _ in self.device_ops:
            by_op[n[:120]] += (e - s) / 1e9
        return {"device_ops": _top(by_op), "idle_gaps": _top(self._gaps())}

    def _gaps(self) -> dict:
        """Idle time between device operations, summed by the operation
        the device waited for (what the host was launching), and the
        slice's edges."""
        out: dict = defaultdict(float)
        end = None
        for s, e, n, _ in sorted(self.device_ops):
            if end is not None and s > end:
                out["launching " + n[:110]] += (s - end) / 1e9
            end = e if end is None else max(end, e)
        out["(slice edges)"] = max(0.0, self.window_s
                                   - (self.t1 - self.t0) / 1e9)
        return out


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def _is_kernel(event, name: str) -> bool:
    kind = getattr(event, "activity_type", None)
    if callable(kind):
        try:
            return "kernel" in str(kind()).lower()
        except (RuntimeError, TypeError):
            pass
    return not name.startswith(("Memcpy", "Memset"))


def record(fn, device):
    """``fn()`` under ``torch.profiler`` (CUDA activity), ended by a device
    sync. Returns ``(fn's result, Trace)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        with span(SLICE_SPAN):
            out = fn()
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t
    return out, from_profile(prof, window_s)


def from_profile(prof, window_s: float) -> Trace:
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device_ops = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        annotation = getattr(ev, "is_user_annotation", None)
        if ev.device_type() != cuda or name in SPANS \
                or (callable(annotation) and annotation()):
            continue
        s = ev.start_ns()
        device_ops.append((s, s + ev.duration_ns(), name,
                           _is_kernel(ev, name)))
    if not device_ops:
        raise RuntimeError("the profiler saw no device operation: "
                           "no device time to report")
    return Trace(device_ops, window_s)
