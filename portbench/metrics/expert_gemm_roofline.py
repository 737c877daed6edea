"""``expert_gemm_roofline``: the least time of the traced slice's grouped
expert products over their kernels' device time. The products are
``torch._grouped_mm`` calls: CUTLASS's grouped kernels (names holding
``GroupProblemShape``) and the call's problem set-up before each
(``prepare_grouped_gemm_data``). The least time: for each ``layer.moe``
span of the slice that carries ``held_rows`` (the forward's; the remat
recompute's stops before it notes them) the three products over those
rows twice (the forward and the recompute) and their input and weight
gradients once, from the family's ``expert_gemm_flops_bytes`` through
``peaks.least_s``."""

from portbench import spans
from portbench.peaks import least_s

KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(cell):
    if getattr(cell, "kind", None) != "train" or cell.trace is None:
        return None
    count = getattr(cell.ctx.family, "expert_gemm_flops_bytes", None)
    device_s = sum(cell.trace.kernel_s(part) for part in KERNELS)
    rows = [(s.get("args") or {}).get("held_rows")
            for s in spans.program_spans(cell, "layer.moe")]
    rows = [r for r in rows if r is not None]
    if count is None or device_s <= 0 or not rows:
        return None
    least = sum(2 * least_s(*count(r, cell.spec))
                + least_s(*count(r, cell.spec, backward=True))
                for r in rows)
    return 100.0 * least / device_s
