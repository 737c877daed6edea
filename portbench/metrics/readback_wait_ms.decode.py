"""``readback_wait_ms.decode``: the mean host time a decode step of the
traced slice was blocked copying its tokens to the host (the program's
``decode.readback`` span, which waits for the step's device work), in
ms."""

from portbench import spans


def read(cell):
    if getattr(cell, "kind", None) != "decode":
        return None
    return spans.mean_ms(cell, "decode.readback")
