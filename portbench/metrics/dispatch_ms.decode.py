"""``dispatch_ms.decode``: the mean host time a decode step of the traced
slice spent dispatching (the program's ``decode.dispatch`` span: from
``ServeDriver.step``'s entry to the argmax), in ms. Beside it on
standard error, the read-back's wait and the slice's time a step."""

import sys

from portbench import spans


def read(cell):
    if getattr(cell, "kind", None) != "decode":
        return None
    dispatch = spans.mean_ms(cell, "decode.dispatch")
    if dispatch is None:
        return None
    wait = spans.mean_ms(cell, "decode.readback") or 0.0
    step = 1e3 * cell.trace.window_s / cell.trace_steps
    print(f"decode spans: dispatch {dispatch:.3f} ms + read-back "
          f"{wait:.3f} ms a step, of the slice's {step:.3f} ms a step",
          file=sys.stderr)
    return dispatch
