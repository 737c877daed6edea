"""``mixer_pct.<kind>``: the device's busy time inside the device
intervals of the program's ``layer.mixer`` spans (each layer's norm and
attention or SSM mixer; in training the forward and the remat
recompute, not the backward), over that inside the kind's step spans
(``train.step``, ``prefill.step``), in the traced slice."""

from portbench import spans

ROOTS = {"train": "train.step", "prefill": "prefill.step"}


def read(cell):
    root = ROOTS.get(getattr(cell, "kind", None))
    if root is None:
        return None
    return spans.device_share(cell, "layer.mixer", root)
