"""The program's own spans in a traced slice: what the port's tracer
(``repro_torch.obs.trace``) recorded while the slice's profiler ran, on
the profiler's clock, and the device's busy time inside them.

A span's host interval is ``(t0, t1)``; a span the program opened with a
device interval also carries ``device``: when the stream reached its
start and its end. Both are clipped against the slice's busy union
(``Trace.merged``): the busy time inside a span's device interval is the
device's work for it, the idle time inside a host interval is time the
device waited while the host was in the program. A program whose tracer
records none of a reader's spans gives the reader nothing to read, and
it returns None.
"""

from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict

from portbench.trace import _merge

NS = 1e9
OUTSIDE = "outside the program"


def program_spans(cell, name: str = None) -> list:
    """The slice's closed program spans (those named ``name``), as the
    tracer exports them; [] without a trace or a tracer. A span of the
    slice lies within ``window_s`` of both its first and its last device
    operation; earlier spans in the tracer's ring are left out."""
    t = getattr(cell, "trace", None)
    if t is None:
        return []
    try:
        from repro_torch.obs.trace import get_tracer
    except ImportError:
        return []
    lo, hi = t.t1 - t.window_s * NS, t.t0 + t.window_s * NS
    return [s for s in get_tracer().export() if s["t1"] is not None
            and lo <= s["t0"] * NS and s["t1"] * NS <= hi
            and (name is None or s["name"] == name)]


def label(span: dict) -> str:
    """A span's name, with its ``kind`` where it has one."""
    kind = (span.get("args") or {}).get("kind")
    return f"{span['name']}[{kind}]" if kind else span["name"]


class Busy:
    """The slice's busy union (ns), for the busy time inside any
    interval."""

    def __init__(self, trace):
        self.starts = [s for s, _ in trace.merged]
        self.ends = [e for _, e in trace.merged]
        self.before = [0.0]                  # busy time before interval i
        for s, e in trace.merged:
            self.before.append(self.before[-1] + e - s)

    def upto(self, t: float) -> float:
        i = bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        return self.before[i - 1] + min(t, self.ends[i - 1]) \
            - self.starts[i - 1]

    def within(self, a: float, b: float) -> float:
        return self.upto(b) - self.upto(a) if b > a else 0.0


def busy_inside(cell, intervals) -> float:
    """Seconds of the slice's busy union inside the union of
    ``intervals`` (seconds on the tracer's clock)."""
    busy = Busy(cell.trace)
    return sum(busy.within(s, e) for s, e in _merge(
        [(s * NS, e * NS) for s, e in intervals])) / NS


def device_share(cell, name: str, root: str):
    """Percent: the busy time inside the device intervals of the spans
    named ``name``, over that inside the ``root`` spans'; None where the
    slice has neither."""
    spans = program_spans(cell)
    part = [s["device"] for s in spans if s["name"] == name and "device" in s]
    whole = [s["device"] for s in spans
             if s["name"] == root and "device" in s]
    if not part or not whole:
        return None
    total = busy_inside(cell, whole)
    return 100.0 * busy_inside(cell, part) / total if total > 0 else None


def mean_ms(cell, name: str):
    """Mean host duration of the spans named ``name``, in ms; None
    without one."""
    spans = program_spans(cell, name)
    if not spans:
        return None
    return 1e3 * sum(s["t1"] - s["t0"] for s in spans) / len(spans)


def idle_by_span(cell):
    """``(seconds, {label: seconds})``: the slice's idle time while the
    host was inside a program span, in all and by the innermost span open
    (the one begun last, on any thread); None without spans."""
    spans = [(s["t0"] * NS, s["t1"] * NS, label(s))
             for s in program_spans(cell)]
    if not spans:
        return None
    busy = Busy(cell.trace)
    points = sorted({p for s, e, _ in spans for p in (s, e)})
    starts = sorted(spans)
    ends = sorted(range(len(starts)), key=lambda i: starts[i][1])
    active: set = set()
    si = ei = 0
    by: dict = defaultdict(float)
    for a, b in zip(points, points[1:]):
        while si < len(starts) and starts[si][0] <= a:
            active.add(si)
            si += 1
        while ei < len(ends) and starts[ends[ei]][1] <= a:
            active.discard(ends[ei])
            ei += 1
        idle = (b - a) - busy.within(a, b)
        if active and idle > 1:                 # over a nanosecond
            by[starts[max(active)][2]] += idle / NS
    return sum(by.values()), dict(by)
