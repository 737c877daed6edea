"""Low-overhead span tracer for the streaming update path.

Design constraints, in order:

* **~zero cost disabled.** The module-global tracer starts disabled;
  hot paths guard with ``if tr.enabled:`` (one attribute read) or call
  ``tr.begin(...)`` unconditionally and get back a shared no-op span.
  `benchmarks/obs_overhead.py` gates both regimes.
* **Low overhead enabled.** Spans land in a preallocated ring buffer of
  plain tuples — no allocation beyond the tuple itself, no locks (each
  OS process owns its tracer; the runtime merges exports), no I/O until
  ``export()``.
* **Cross-process causality.** Span/trace ids are salted with the pid
  so merged dumps never collide, and the default clock is
  ``time.perf_counter`` — CLOCK_MONOTONIC on Linux, which is
  system-wide, so timestamps from different processes line up on one
  Perfetto timeline. The Pusher stamps ``trace``/``span``/``t_push``
  into ``Record.meta``, which crosses the FileQueue for free (records
  are whole-pickled frames), letting the consumer reconstruct the
  queue-dwell span and parent the apply under it.

``summarize`` renders exported spans as per-stage span counts and
p50/p99 durations, plus the slowest trace printed as a causal tree. The
Perfetto JSON export and its command-line viewer are not ported yet.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional


class _NullSpan:
    """Shared no-op returned by a disabled tracer's ``begin``/``span``."""

    __slots__ = ()
    id = 0
    trace = 0
    t0 = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "trace", "id", "parent", "t0", "attrs")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._tracer.end(self)
        return False


class Tracer:
    """Ring-buffered span recorder. One per OS process.

    Spans are stored as ``(name, trace, span, parent, t0, t1, attrs)``
    tuples; ``t1 is None`` marks an instant annotation. ``export()``
    returns dicts in ring order (oldest first) tagged with this
    tracer's process name.
    """

    def __init__(
        self,
        *,
        capacity: int = 1 << 15,
        clock: Optional[Callable[[], float]] = None,
        process: str = "main",
        enabled: bool = True,
    ):
        self.enabled = enabled
        self.clock = clock or time.perf_counter
        self.process = process
        self.capacity = int(capacity)
        self._buf: list = [None] * self.capacity
        self._n = 0  # spans ever recorded (ring wraps past capacity)
        self._ctx: list = []  # (trace, span) stack for implicit parenting
        self._open: dict = {}  # id -> _Span, begun but not yet ended
        # pid-salted id base: spans from different processes never
        # collide when their exports are merged supervisor-side
        self._base = (os.getpid() & 0xFFFF) << 32
        self._next = 0

    # -- ids ----------------------------------------------------------

    def _new_id(self) -> int:
        self._next += 1
        return self._base | self._next

    def new_trace(self) -> int:
        """Fresh trace id for a new causal chain (one pusher flush)."""
        return self._new_id()

    def current(self) -> tuple:
        """(trace, span) of the innermost open span, or (0, 0)."""
        return self._ctx[-1] if self._ctx else (0, 0)

    @property
    def dropped(self) -> int:
        """Spans evicted by ring wrap-around."""
        return max(0, self._n - self.capacity)

    # -- recording ----------------------------------------------------

    def begin(self, name: str, *, trace: Optional[int] = None,
              parent: Optional[int] = None, **attrs):
        """Open a span; close it with ``end`` or use as a context
        manager (``span`` is an alias). Unspecified trace/parent come
        from the innermost open span, so nesting is implicit."""
        if not self.enabled:
            return _NULL_SPAN
        if trace is None:
            trace, ctx_parent = self.current()
            if parent is None:
                parent = ctx_parent
        elif parent is None:
            parent = 0
        sp = _Span()
        sp._tracer = self
        sp.name = name
        sp.trace = trace
        sp.parent = parent
        sp.id = self._new_id()
        sp.attrs = attrs or None
        self._ctx.append((trace, sp.id))
        self._open[sp.id] = sp
        sp.t0 = self.clock()
        return sp

    span = begin

    def end(self, sp) -> None:
        if sp is _NULL_SPAN:
            return
        t1 = self.clock()
        self._open.pop(sp.id, None)
        if self._ctx:
            if self._ctx[-1][1] == sp.id:          # common case: LIFO
                self._ctx.pop()
            else:                                  # out-of-order end
                for i in range(len(self._ctx) - 1, -1, -1):
                    if self._ctx[i][1] == sp.id:
                        del self._ctx[i]
                        break
        self._put(sp.name, sp.trace, sp.id, sp.parent, sp.t0, t1, sp.attrs)

    def record(self, name: str, *, t0: float, t1: float, trace: int = 0,
               parent: int = 0, **attrs) -> int:
        """Record a completed span with explicit timestamps — used for
        spans reconstructed after the fact, like queue dwell measured
        from a record's ``t_push`` stamp at the consumer. Returns the
        new span id (0 when disabled)."""
        if not self.enabled:
            return 0
        sid = self._new_id()
        self._put(name, trace, sid, parent, t0, t1, attrs or None)
        return sid

    def instant(self, name: str, *, trace: Optional[int] = None,
                **attrs) -> int:
        """Zero-duration annotation (fault firings, recovery markers)."""
        if not self.enabled:
            return 0
        ctx_trace, ctx_parent = self.current()
        if trace is None:
            trace = ctx_trace
        sid = self._new_id()
        self._put(name, trace, sid, ctx_parent, self.clock(), None,
                  attrs or None)
        return sid

    def _put(self, name, trace, sid, parent, t0, t1, attrs) -> None:
        self._buf[self._n % self.capacity] = (
            name, trace, sid, parent, t0, t1, attrs)
        self._n += 1

    # -- export -------------------------------------------------------

    def export(self) -> list:
        """Span dicts, oldest first."""
        n, cap = self._n, self.capacity
        if n <= cap:
            entries = self._buf[:n]
        else:
            k = n % cap
            entries = self._buf[k:] + self._buf[:k]
        out = []
        for name, trace, sid, parent, t0, t1, attrs in entries:
            d = {"name": name, "proc": self.process, "trace": trace,
                 "span": sid, "parent": parent, "t0": t0, "t1": t1}
            if attrs:
                d["args"] = dict(attrs)
            out.append(d)
        # still-open spans export too, clipped at "now" and flagged
        # partial — a SIGKILL mid-span (the pre-kill dump hook) must
        # not orphan children whose parent never reached the ring
        if self._open:
            t1 = self.clock()
            for sp in sorted(self._open.values(), key=lambda s: s.t0):
                d = {"name": sp.name, "proc": self.process,
                     "trace": sp.trace, "span": sp.id,
                     "parent": sp.parent, "t0": sp.t0, "t1": t1,
                     "args": dict(sp.attrs or (), partial=True)}
                out.append(d)
        return out

    def clear(self) -> None:
        self._buf = [None] * self.capacity
        self._n = 0
        self._ctx = []
        self._open = {}


# -- module-global tracer ---------------------------------------------
# Disabled by default with a 1-slot ring so an untraced process pays
# one tiny object. configure() swaps in a live tracer.

_tracer = Tracer(enabled=False, capacity=1)


def get_tracer() -> Tracer:
    return _tracer


def configure(*, enabled: bool = True, capacity: int = 1 << 15,
              clock: Optional[Callable[[], float]] = None,
              process: str = "main") -> Tracer:
    """Install (and return) a fresh process-global tracer."""
    global _tracer
    _tracer = Tracer(capacity=capacity, clock=clock, process=process,
                     enabled=enabled)
    return _tracer


def disable() -> Tracer:
    """Back to the zero-cost disabled state."""
    return configure(enabled=False, capacity=1)


# -- viewer / summarizer ----------------------------------------------

def _percentile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    k = (len(sorted_vals) - 1) * (q / 100.0)
    lo = int(k)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (k - lo)


def stage_stats(spans: list) -> dict:
    """Per-stage (span name) count + p50/p99 duration in ms."""
    by_name: dict = {}
    for s in spans:
        if s["t1"] is None:
            continue
        by_name.setdefault(s["name"], []).append(
            max(0.0, s["t1"] - s["t0"]) * 1e3)
    out = {}
    for name in sorted(by_name):
        vals = sorted(by_name[name])
        out[name] = {"count": len(vals),
                     "p50_ms": _percentile(vals, 50),
                     "p99_ms": _percentile(vals, 99)}
    return out


def trace_groups(spans: list) -> dict:
    """Spans grouped by non-zero trace id, each sorted by t0."""
    groups: dict = {}
    for s in spans:
        if s["trace"]:
            groups.setdefault(s["trace"], []).append(s)
    for g in groups.values():
        g.sort(key=lambda s: s["t0"])
    return groups


def slowest_traces(spans: list, n: int = 3) -> list:
    """The n longest traces as (trace_id, duration_s, spans)."""
    scored = []
    for tid, group in trace_groups(spans).items():
        t0 = min(s["t0"] for s in group)
        t1 = max(s["t1"] if s["t1"] is not None else s["t0"] for s in group)
        scored.append((tid, t1 - t0, group))
    scored.sort(key=lambda x: -x[1])
    return scored[:n]


def format_tree(group: list, t_base: Optional[float] = None) -> str:
    """Render one trace's spans as an indented causal tree."""
    if t_base is None:
        t_base = min(s["t0"] for s in group)
    ids = {s["span"] for s in group}
    kids: dict = {}
    roots = []
    for s in group:
        if s["parent"] in ids:
            kids.setdefault(s["parent"], []).append(s)
        else:
            roots.append(s)
    lines: list = []

    def walk(s, depth):
        dur = "" if s["t1"] is None else f" {1e3 * (s['t1'] - s['t0']):8.3f}ms"
        extra = f"  {s['args']}" if s.get("args") else ""
        lines.append(f"  {1e3 * (s['t0'] - t_base):9.3f}ms "
                     f"{'  ' * depth}{s['name']} [{s['proc']}]{dur}{extra}")
        for c in sorted(kids.get(s["span"], []), key=lambda c: c["t0"]):
            walk(c, depth + 1)

    for r in sorted(roots, key=lambda s: s["t0"]):
        walk(r, 0)
    return "\n".join(lines)


def summarize(spans: list, slowest: int = 3) -> str:
    """Human-readable report: per-stage p50/p99 + slowest-trace trees."""
    lines = [f"{len(spans)} spans, "
             f"{len(trace_groups(spans))} traces, "
             f"{len({s['proc'] for s in spans})} processes", "",
             f"{'stage':<28}{'count':>8}{'p50_ms':>10}{'p99_ms':>10}"]
    for name, st in stage_stats(spans).items():
        lines.append(f"{name:<28}{st['count']:>8}"
                     f"{st['p50_ms']:>10.3f}{st['p99_ms']:>10.3f}")
    annotations = [s for s in spans if s["t1"] is None]
    if annotations:
        lines.append("")
        lines.append("annotations:")
        for s in annotations:
            extra = f"  {s['args']}" if s.get("args") else ""
            lines.append(f"  {s['name']} [{s['proc']}]{extra}")
    for tid, dur, group in slowest_traces(spans, slowest):
        lines.append("")
        lines.append(f"trace {tid:#x}  ({1e3 * dur:.3f}ms, "
                     f"{len(group)} spans)")
        lines.append(format_tree(group))
    return "\n".join(lines)
