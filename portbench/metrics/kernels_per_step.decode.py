"""``kernels_per_step.decode``: CUDA kernels the profiler saw in the
traced slice, a decode step (every kernel, the port's own and torch's:
the host's dispatch work)."""


def read(cell):
    if getattr(cell, "kind", None) != "decode" or cell.trace is None:
        return None
    return cell.trace.kernel_count() / cell.trace_steps
