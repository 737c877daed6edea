"""``backward_pct.train``: the device's busy time inside the device
intervals of the program's ``train.backward`` spans (``autograd.grad``,
the remat recompute included), over that inside its ``train.step``
spans, in the traced slice."""

from portbench import spans


def read(cell):
    if getattr(cell, "kind", None) != "train":
        return None
    return spans.device_share(cell, "train.backward", "train.step")
