"""``idle_in_program_pct.<kind>``: the share of the traced slice in which
no device operation ran while the host was inside a program span (the
port's tracer's spans, on the profiler's clock); read where the slice
holds the kind's step spans (``train.step``, ``prefill.step``,
``decode.step``). The rest of the idle share (``idle_pct``) fell while
the host was outside the program: in the benchmark's own code, or
between calls.

Prints on standard error the slice's idle time by the innermost program
span open (the ten largest), the idle time outside the program on a line
of its own, and the busy time inside the step spans' device intervals
against the slice's."""

import sys

from portbench import spans

STEPS = {"train": "train.step", "prefill": "prefill.step",
         "decode": "decode.step"}


def read(cell):
    step = STEPS.get(getattr(cell, "kind", None))
    if step is None or not spans.program_spans(cell, step):
        return None
    inside, by = spans.idle_by_span(cell)
    t = cell.trace
    print(f"idle in the program {inside:.4f} s of the slice's "
          f"{t.window_s - t.busy_s:.4f} s idle ({t.window_s:.4f} s):",
          file=sys.stderr)
    for name, s in sorted(by.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  idle in {name} {s:.4f} s", file=sys.stderr)
    print(f"  idle {spans.OUTSIDE} "
          f"{max(0.0, t.window_s - t.busy_s - inside):.4f} s",
          file=sys.stderr)
    dev = [s["device"] for s in spans.program_spans(cell, step)
           if "device" in s]
    if dev:
        print(f"  busy inside {step} {spans.busy_inside(cell, dev):.4f} s "
              f"of the slice's {t.busy_s:.4f} s", file=sys.stderr)
    return 100.0 * inside / t.window_s
