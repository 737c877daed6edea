"""The readings that a cell's limits are set from, on the card at the
cell's own size: for each seed, the program's compared numbers (set-up,
a short window at the cell's load, the check) and the control's (the
plain reference in fp8 in the program's place, on the same inputs; for
the served cells at each position of the same prompts and fed tokens),
and for a training cell each fault it can have, put in the program's
place. The benchmark's own runs do not run it.

    python3 portbench/control.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...] [--control-seeds <k>]

One JSON line a seed: ``{"seed", "program": {name: value}}``, every
number the check reads, compared or not; on the first ``k`` seeds also
``"control": {name: value}`` and, for a training cell, ``"faults":
{fault: {name: value}}``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
for _p in (_ROOT / "src", _ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench import harness  # noqa: E402
from portbench.run import Context  # noqa: E402


def readings(ctx: Context, seconds: float, with_control: bool) -> dict:
    """The program's numbers for one seed, compared or not; with
    ``with_control`` the control's and the faults' too."""
    import torch
    cell = harness.kind_module(ctx.mix["kind"]).Cell(ctx)
    cell.setup()
    if seconds > 0:
        cell.window(seconds)
    cell.release()
    out = {"seed": ctx.seed, "program": cell.readings()}
    if with_control:
        out["control"] = cell.control()
        if hasattr(cell, "faults"):
            out["faults"] = cell.faults()
    del cell
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="read the control and the faults on the first "
                         "this many seeds only (default: every seed)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 3
    manifest = harness.load_manifest()
    cell = harness.entry(manifest["workloads"], args.workload)
    spec = harness.config_spec(manifest, cell["config"])
    mix = harness.traffic_mix(cell["traffic"])
    n_control = len(args.seeds) if args.control_seeds is None \
        else args.control_seeds
    for i, seed in enumerate(args.seeds):
        ctx = Context(args.workload, spec, mix, seed, torch.device("cuda", 0),
                      harness.limits(args.workload))
        print(json.dumps(readings(ctx, args.seconds, i < n_control)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
