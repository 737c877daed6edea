"""``head_pct.prefill``: the device's busy time inside the device
intervals of the program's ``model.head`` spans (the vocabulary
projection over every position), over that inside its ``prefill.step``
spans, in the traced slice."""

from portbench import spans


def read(cell):
    if getattr(cell, "kind", None) != "prefill":
        return None
    return spans.device_share(cell, "model.head", "prefill.step")
