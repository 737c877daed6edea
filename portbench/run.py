"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix,
limits and per-layer readers are found by the names ``BENCHMARK.json``
gives (see ``portbench/README.md``). The run makes its weights and
inputs from ``--seed``, warms up, measures for ``--seconds`` (with
``--trace 1`` then profiles a bounded slice of further work items),
checks what the timed path produced against the plain reference, and
prints one JSON line last on standard output. It exits non-zero, with
no result, without the CUDA cards the cell asks for, or when a module of
the JAX stack or of the JAX package is loaded when it ends.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
for _p in (_ROOT / "src", _ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench import harness  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Context:
    """What a cell's driver is given: the configuration's sizes, the
    traffic mix, the seed, the device, the limits, and the family's
    plain reference module."""

    def __init__(self, workload: str, spec: dict, mix: dict, seed: int,
                 device, limits: dict, start: float = None):
        self.start = time.time() if start is None else start
        self.workload = workload
        self.spec = spec
        self.mix = mix
        self.seed = seed
        self.device = device
        self.limits = limits
        self.family = harness.family_module(spec["family"])

    def log(self, what: str) -> None:
        """A line on standard error with the seconds since the start."""
        print(f"portbench [{time.time() - self.start:7.1f} s] {what}",
              file=sys.stderr, flush=True)


def run_cell(ctx: Context, seconds: float, trace: bool,
             metric_defs: list) -> dict:
    """Set-up, window, optional traced slice and check of one cell on
    ``ctx.device``. Returns the result line's dict (without the import
    check, which ``main`` makes last)."""
    import torch
    cell = harness.kind_module(ctx.mix["kind"]).Cell(ctx)
    ctx.log("set-up")
    cell.setup()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    # the start-up's objects (the imported modules' and set-up's, ~10^6)
    # out of the collector's reach for the window, as a long-running
    # trainer or server freezes them after start-up: their full
    # collections set the spread of a train window (0.6-1.3 s of 30)
    gc.collect()
    gc.freeze()
    setup_s = time.time() - ctx.start
    ctx.log("window")
    cell.window(seconds)
    if trace:
        ctx.log("traced slice")
        cell.traced()
    gc.unfreeze()
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    cell.release()
    ctx.log("check")
    checks = cell.check()
    ctx.log("checked")
    metrics = {}
    for m in metric_defs:
        if m["name"] == "setup_s":
            value = setup_s
        elif trace:
            value = harness.metric_reader(m["name"])(cell)
        else:
            value = cell.end_to_end(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(ctx.device)
                       if ctx.device.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": harness.all_within(checks) and cell.failed == 0,
           "attempted": cell.attempted, "failed": cell.failed,
           "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = cell.trace.busy_s
        device["window_s"] = cell.trace.window_s
        out["breakdown"] = cell.trace.breakdown()
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    start = harness.process_start()
    args = parse_args(argv)
    manifest = harness.load_manifest()
    cell = harness.entry(manifest["workloads"], args.workload)
    # kernel caches at fixed places inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(_ROOT / "build" / "triton")
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    ctx = Context(args.workload, harness.config_spec(manifest, cell["config"]),
                  harness.traffic_mix(cell["traffic"]), args.seed,
                  torch.device("cuda", 0), harness.limits(args.workload),
                  start)
    defs = harness.cell_metrics(manifest, args.workload, bool(args.trace))
    result = run_cell(ctx, args.seconds, bool(args.trace), defs)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
