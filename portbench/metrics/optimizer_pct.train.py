"""``optimizer_pct.train``: the device's busy time inside the device
intervals of the program's ``train.optimizer`` spans (the optimizer's
in-place update), over that inside its ``train.step`` spans, in the
traced slice."""

from portbench import spans


def read(cell):
    if getattr(cell, "kind", None) != "train":
        return None
    return spans.device_share(cell, "train.optimizer", "train.step")
