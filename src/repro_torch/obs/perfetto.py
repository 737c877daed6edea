"""Chrome/Perfetto trace-event JSON for ``repro_torch.obs.trace`` spans —
a copy of the reference's ``obs/perfetto.py`` (pure JSON, stdlib only).

The on-disk format is the Chrome Trace Event JSON object form
(https://ui.perfetto.dev loads it directly): spans become "X" complete
events (ts/dur in microseconds, rebased to the earliest span), instant
annotations become "i" events, and each trace id additionally emits
flow events ("s" start / "t" step) so Perfetto draws arrows across the
process tracks of one causal chain. Per-process "M" metadata events
name the tracks after the tracer's process string.

Span identity (trace/span/parent ids) rides in each event's ``args``,
which makes the file round-trippable: ``load_spans`` reconstructs the
span dicts, and ``merge_spans`` combines exports from many processes
(supervisor ring + worker ``trace_dump`` RPCs + pre-kill dump files)
into one deduplicated timeline.
"""

from __future__ import annotations

import json

_SPAN_KEYS = ("trace", "span", "parent")


def to_chrome(spans: list) -> dict:
    """Chrome trace-event JSON object for a list of span dicts."""
    spans = [s for s in spans if s]
    procs = sorted({s["proc"] for s in spans})
    pid = {p: i + 1 for i, p in enumerate(procs)}
    base = min((s["t0"] for s in spans), default=0.0)
    events = [
        {"ph": "M", "name": "process_name", "pid": i, "tid": 0,
         "args": {"name": p}}
        for p, i in pid.items()
    ]
    flow_started: set = set()
    for s in sorted(spans, key=lambda s: s["t0"]):
        ts = (s["t0"] - base) * 1e6
        args = {"trace": s["trace"], "span": s["span"],
                "parent": s["parent"]}
        args.update(s.get("args") or {})
        common = {"name": s["name"], "cat": "weips",
                  "pid": pid[s["proc"]], "tid": 0, "args": args}
        if s["t1"] is None:
            events.append({**common, "ph": "i", "ts": ts, "s": "p"})
        else:
            dur = max(0.0, (s["t1"] - s["t0"]) * 1e6)
            events.append({**common, "ph": "X", "ts": ts, "dur": dur})
        tid = s["trace"]
        if tid:
            ph = "s" if tid not in flow_started else "t"
            flow_started.add(tid)
            events.append({"ph": ph, "id": tid, "name": "update",
                           "cat": "sync", "pid": pid[s["proc"]],
                           "tid": 0, "ts": ts})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"t_base": base, "format": "repro.obs/1"}}


def write_trace(path: str, spans: list) -> int:
    """Write spans as a Perfetto-loadable file; returns span count."""
    doc = to_chrome(spans)
    with open(path, "w") as f:
        json.dump(doc, f)
    return sum(1 for e in doc["traceEvents"] if e["ph"] in ("X", "i"))


def load_spans(path: str) -> list:
    """Inverse of write_trace: span dicts back out of a trace file."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", [])
    base = doc.get("otherData", {}).get("t_base", 0.0)
    proc = {e["pid"]: e["args"]["name"] for e in events
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    spans = []
    for e in events:
        if e.get("ph") not in ("X", "i") or "span" not in e.get("args", {}):
            continue
        a = e["args"]
        t0 = base + e["ts"] / 1e6
        t1 = t0 + e["dur"] / 1e6 if e["ph"] == "X" else None
        d = {"name": e["name"], "proc": proc.get(e["pid"], str(e["pid"])),
             "trace": a["trace"], "span": a["span"],
             "parent": a["parent"], "t0": t0, "t1": t1}
        extra = {k: v for k, v in a.items() if k not in _SPAN_KEYS}
        if extra:
            d["args"] = extra
        spans.append(d)
    return spans


def merge_spans(*span_lists) -> list:
    """Merge per-process exports into one t0-ordered list.

    Dedup key is the pid-salted span id (plus name, so a respawned
    worker that reuses a pid cannot silently swallow a span from its
    previous life's dump file).
    """
    seen: set = set()
    out = []
    for spans in span_lists:
        for s in spans or ():
            key = (s["span"], s["name"], s["t0"])
            if key in seen:
                continue
            seen.add(key)
            out.append(s)
    out.sort(key=lambda s: s["t0"])
    return out
