"""``graph_replay_pct.decode``: the share of the traced slice's decode
steps whose dispatch replayed a captured CUDA graph (the program's
``decode.dispatch`` spans whose ``graph`` attribute is ``replay``), in
percent. None where the program's dispatch spans carry no such
attribute."""

from portbench import spans


def read(cell):
    if getattr(cell, "kind", None) != "decode":
        return None
    modes = [(s.get("args") or {}).get("graph")
             for s in spans.program_spans(cell, "decode.dispatch")]
    if not any(modes):
        return None
    return 100.0 * modes.count("replay") / len(modes)
