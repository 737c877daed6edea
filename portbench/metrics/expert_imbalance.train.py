"""``expert_imbalance.train``: the most rows any held expert took over
the mean of the held experts' rows, averaged over the traced slice's
``layer.moe`` spans (their ``max_rows`` and ``held_rows``, which the
program's tracer reads after the slice); 1 is an even load. None where
the spans carry no such attributes."""

from portbench import spans


def read(cell):
    if getattr(cell, "kind", None) != "train":
        return None
    held = cell.spec.get("num_local_experts")
    ratios = []
    for s in spans.program_spans(cell, "layer.moe"):
        args = s.get("args") or {}
        if held and args.get("held_rows"):
            ratios.append(args["max_rows"] * held / args["held_rows"])
    return sum(ratios) / len(ratios) if ratios else None
