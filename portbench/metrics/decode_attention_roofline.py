"""``decode_attention_roofline``: the least time of the traced slice's
``decode_attention`` calls (each step's attention layers reading every
sequence's K and V rows below its length, q and the output, over the
memory rate), over the kernel's device time in the trace."""

from portbench.peaks import HBM_BYTES_PER_S


def read(cell):
    if getattr(cell, "kind", None) != "decode" or cell.trace is None:
        return None
    spec = cell.spec
    device_s = cell.trace.kernel_s("decode_attention")
    if device_s <= 0:
        return None
    cache_bytes = 2 if cell.mix["cache_dtype"] == "bfloat16" else 4
    act_bytes = 2 if spec["torch_dtype"] == "bfloat16" else 4
    nbytes = sum(spec["num_hidden_layers"]
                 * cell.ctx.family.decode_attention_bytes(
                     cell.lengths(t), spec["num_attention_heads"],
                     spec["num_key_value_heads"], spec["head_dim"],
                     cache_bytes, act_bytes, act_bytes)
                 for t in range(cell.trace_first,
                                cell.trace_first + cell.trace_steps))
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s
