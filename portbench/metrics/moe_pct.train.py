"""``moe_pct.train``: the device's busy time inside the device intervals
of the program's ``layer.moe`` spans (each MoE layer's norm, router,
dropless dispatch, grouped expert products, combine and shared expert;
the forward and the remat recompute, not the backward), over that
inside its ``train.step`` spans, in the traced slice."""

from portbench import spans


def read(cell):
    if getattr(cell, "kind", None) != "train":
        return None
    return spans.device_share(cell, "layer.moe", "train.step")
