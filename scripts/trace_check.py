#!/usr/bin/env python3
"""The port's span tracer (``repro_torch.obs.trace``) against
``torch.profiler``, and what tracing costs.

- Off cost (any host): one span's cost with no profiler, the tracer
  following it (the default).
- Shared clock (a card): under a profiler of host and device activity, a
  ``device=True`` span around one bf16 matmul queued behind another
  against that kernel's interval in the trace, and a host span against a
  ``record_function`` around it, whose stamps are also placed between
  the tracer's clock readings around them; the distances at either end
  of each of ``--repeats`` tries (the first a cold profiler session, as
  the benchmark's traced slice is), in microseconds.
- On cost (a card, ``--workload``): a benchmark cell's steps inside
  profiler sessions (CUDA activity, as the benchmark's traced slice),
  with the tracer following the profiler and forced off
  (``configure(enabled=False)``) in turns; each step's host time (its
  start to its read-back or sync): the medians, each session's median
  and the trace's idle share for each.

    python3 scripts/trace_check.py [--workload qwen2-1.5b.decode] \\
        [--seed 7] [--rounds 4] [--steps 16]

Prints one JSON line a part.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from repro_torch.obs import trace as obs_trace  # noqa: E402


def off_cost(n: int = 200_000) -> dict:
    """Nanoseconds a ``with span(...)`` costs with no profiler, and a
    bare ``with`` on the null span beside it."""
    import torch  # noqa: F401  (the profiler's flag lives in torch)
    obs_trace.disable()

    def span():
        with obs_trace.get_tracer().span("layer.mixer", device=True,
                                         kind="attention"):
            pass

    def bare():
        with obs_trace._NULL_SPAN:
            pass

    out = {}
    for name, fn in (("span_ns", span), ("null_with_ns", bare)):
        out[name] = min(timeit.repeat(fn, number=n, repeat=5)) / n * 1e9
    return {"part": "off_cost", **out}


def clock_check(repeats: int) -> dict:
    """Distances (µs) between the tracer's spans and the profiler's
    events around the same work."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    dev = torch.device("cuda", 0)
    a = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
    for _ in range(3):
        a @ a
    torch.cuda.synchronize(dev)
    obs_trace.disable()
    tr = obs_trace.get_tracer()
    dist = {"device_start_us": [], "device_end_us": [],
            "host_start_us": [], "host_end_us": [],
            "range_start_after_clock_us": [],
            "clock_after_range_start_us": [],
            "range_end_after_clock_us": [], "clock_after_range_end_us": []}
    for i in range(repeats):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with tr.span("check.anchor", device=True):
                pass
            torch.cuda.synchronize(dev)
            a @ a                                  # the queue ahead
            with tr.span("check.matmul", device=True):
                a @ a
            torch.cuda.synchronize(dev)
            before = tr.clock()
            with record_function("check.range"):
                inside = tr.clock()
                with tr.span("check.host"):
                    time.sleep(0.001)
                leaving = tr.clock()
            after = tr.clock()
        spans = {s["name"]: s for s in tr.export()}
        evs = list(prof.profiler.kineto_results.events())
        cuda = torch.autograd.DeviceType.CUDA
        rng = next(e for e in evs if e.name() == "check.range"
                   and e.device_type() != cuda)
        kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                         for e in evs if e.device_type() == cuda
                         and not e.name().startswith("check."))
        d0, d1 = (t * 1e9 for t in spans["check.matmul"]["device"])
        # the kernel nearest the span's device interval
        k0, k1 = min(kernels, key=lambda k: abs(k[0] - d0) + abs(k[1] - d1))
        h = spans["check.host"]
        r0, r1 = rng.start_ns(), rng.start_ns() + rng.duration_ns()
        dist["device_start_us"].append((k0 - d0) / 1e3)
        dist["device_end_us"].append((d1 - k1) / 1e3)
        dist["host_start_us"].append((h["t0"] * 1e9 - r0) / 1e3)
        dist["host_end_us"].append((r1 - h["t1"] * 1e9) / 1e3)
        # the range's stamps between the tracer's clock readings around
        # them: each of these is >= 0 on one clock
        dist["range_start_after_clock_us"].append((r0 - before * 1e9) / 1e3)
        dist["clock_after_range_start_us"].append((inside * 1e9 - r0) / 1e3)
        dist["range_end_after_clock_us"].append((r1 - leaving * 1e9) / 1e3)
        dist["clock_after_range_end_us"].append((after * 1e9 - r1) / 1e3)
        obs_trace.disable()
        tr = obs_trace.get_tracer()
    return {"part": "clock", "repeats": repeats, **dist}


def on_cost(workload: str, seed: int, rounds: int, steps: int) -> dict:
    """A cell's steps in profiler sessions, the tracer following and
    forced off in turns (follow, off, off, follow, ...)."""
    import torch

    from portbench import harness
    from portbench import trace as bench_trace
    from portbench.run import Context
    manifest = harness.load_manifest()
    cell_entry = harness.entry(manifest["workloads"], workload)
    ctx = Context(workload, harness.config_spec(manifest,
                                                cell_entry["config"]),
                  harness.traffic_mix(cell_entry["traffic"]), seed,
                  torch.device("cuda", 0), harness.limits(workload))
    cell = harness.kind_module(ctx.mix["kind"]).Cell(ctx)
    cell.setup()
    step = cell._next_batch if ctx.mix["kind"] == "prefill" else cell._step

    def timed():
        out = []
        for _ in range(steps):
            t = time.perf_counter()
            step()
            out.append(time.perf_counter() - t)
        return out

    times = {"follow": [], "off": []}
    session = {"follow": [], "off": []}
    idle = {"follow": [], "off": []}
    spans = {"follow": [], "off": []}
    bench_trace.record(timed, ctx.device)               # warm the profiler
    order = ["follow", "off", "off", "follow"] * ((rounds + 1) // 2)
    for mode in order[:2 * rounds]:
        obs_trace.configure(enabled=None if mode == "follow" else False)
        got, trace = bench_trace.record(timed, ctx.device)
        times[mode] += got
        session[mode].append(statistics.median(got) * 1e3)
        idle[mode].append(100.0 * (1 - trace.busy_s / trace.window_s))
        spans[mode].append(len(obs_trace.get_tracer().export()))
        obs_trace.disable()
    cell.release()
    med = {m: statistics.median(v) * 1e3 for m, v in times.items()}
    return {"part": "on_cost", "workload": workload, "seed": seed,
            "steps_each": len(times["follow"]),
            "median_ms": med,
            "cost_pct": 100.0 * (med["follow"] / med["off"] - 1),
            "quartiles_ms": {m: [q * 1e3 for q in statistics.quantiles(
                v, n=4)] for m, v in times.items()},
            "session_median_ms": session, "idle_pct": idle,
            "spans_a_session": spans}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", action="append", default=[])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    print(json.dumps(off_cost()), flush=True)
    import torch
    if not torch.cuda.is_available():
        print("trace_check: no CUDA card; the clock and on-cost parts "
              "need one", file=sys.stderr)
        return 0 if not args.workload else 3
    print(json.dumps(clock_check(args.repeats)), flush=True)
    for w in args.workload:
        print(json.dumps(on_cost(w, args.seed, args.rounds, args.steps)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
