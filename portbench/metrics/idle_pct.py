"""``idle_pct.<kind>``: the share of the traced slice in which no device
operation ran (the union of the kernels', copies' and fills' intervals,
from the profiler's trace)."""


def read(cell):
    if cell.trace is None:
        return None
    t = cell.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s)
