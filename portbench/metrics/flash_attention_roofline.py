"""``flash_attention_roofline``: the least time of the traced slice's
``flash_attention`` calls (each batch's attention layers at its length:
the larger of the kept causal pairs' FLOPs over the bf16 peak and q, k,
v and o read or written once over the memory rate), over the kernels'
device time in the trace."""

from portbench.peaks import least_s


def read(cell):
    if getattr(cell, "kind", None) != "prefill" or cell.trace is None:
        return None
    spec = cell.spec
    device_s = cell.trace.kernel_s("flash_attention")
    if device_s <= 0:
        return None
    least = sum(spec["num_hidden_layers"] * least_s(
        *cell.ctx.family.flash_flops_bytes(
            cell.batch, spec["num_attention_heads"],
            spec["num_key_value_heads"], n, spec["head_dim"]))
        for n in cell.trace_lengths)
    return 100.0 * least / device_s
