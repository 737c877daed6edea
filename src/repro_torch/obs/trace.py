"""Low-overhead span tracer of the port: the CTR paths (runtime, sync
stream, serving cache, SLO harness) and the LM hot paths (train step,
backward, optimizer, each layer's mixer, the head, prefill and decode).

Design constraints, in order:

* **~zero cost when not recording.** The module-global tracer follows
  ``torch.profiler``: it records while a profiler session records, and
  always once ``configure()`` turns it on (``configure(enabled=False)``
  keeps it off even under a profiler). Otherwise ``begin`` costs one
  check of torch's own profiler flag and returns a shared no-op span;
  hot paths may also guard with ``if tr.enabled:``. Any profile of the
  program thus carries its spans, and nothing outside the program has
  to switch them on.
* **Low overhead enabled.** Spans land in a ring buffer of plain tuples,
  allocated at the first span — no allocation beyond the tuple itself,
  one short lock (the ring is shared by the process's threads), no I/O
  until ``export()``.
* **One clock with the device trace.** The default clock is
  ``time.time``: the wall clock that ``torch.profiler`` stamps its host
  events with, and onto which it puts CUPTI's device timestamps, so a
  span lies beside the profiler's operations. The wall clock is
  system-wide, as CLOCK_MONOTONIC is, so timestamps from different
  processes line up on one Perfetto timeline (``obs.perfetto`` rebases
  to the earliest span). Span/trace ids are salted with the pid so
  merged dumps never collide. The Pusher stamps ``trace``/``span``/
  ``t_push`` into ``Record.meta``, which crosses the FileQueue for free
  (records are whole-pickled frames), letting the consumer reconstruct
  the queue-dwell span and parent the apply under it.
* **Nesting per thread.** Open spans nest per thread (autograd runs a
  CUDA backward, and so the remat recompute, on its own device thread),
  and each span records the native id of its thread.
* **Device scalars.** ``span.set(name=tensor)`` attaches a value the
  step computes on the device (a MoE layer's routed rows); the tracer
  keeps the tensor and reads it at ``export()``, so a traced step never
  waits on a read-back.
* **Device intervals.** A span begun with ``device=True`` while CUDA is
  initialised records a pair of timing CUDA events, from a pool, on the
  current stream. ``export()`` synchronises, reads them and puts them on
  the tracer's clock through the anchor of their recording session
  (sync, record an event, wait for it, read the clock: the try, of up
  to 20, that took least since a reading before the record; at the
  session's first device span) and the mark that ``export`` takes the
  same way, between which it interpolates. On the CPU a device span has
  no device interval.

``summarize`` renders exported spans as per-stage span counts and
p50/p99 durations, plus the slowest trace printed as a causal tree;
``obs.perfetto`` writes and loads the Chrome/Perfetto JSON, and ``main``
is the viewer of such a dump: ``python -m repro_torch.obs.trace
trace.json [--slowest N]``.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from typing import Callable, Optional


def _profiling() -> bool:
    """Whether a ``torch.profiler`` session is recording: the flag torch
    keeps for fast checks (False where torch is not loaded)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def _on_card() -> bool:
    """Whether CUDA is initialised in this process."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


class _NullSpan:
    """Shared no-op returned by ``begin``/``span`` when not recording."""

    __slots__ = ()
    id = 0
    trace = 0
    t0 = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_stack", "name", "trace", "id", "parent", "t0",
                 "attrs", "tid", "dev")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._tracer.end(self)
        return False

    def set(self, **attrs) -> None:
        """Add attributes to the open span. A tensor (a device scalar the
        step computed) is kept as it is and read at ``export()``, so the
        step never waits for it."""
        self.attrs = {**(self.attrs or {}), **attrs}


def _read_attrs(attrs: dict) -> dict:
    """``attrs`` with each tensor read to a Python number, in place (the
    next export reads the number, and the tensor is freed)."""
    for k, v in attrs.items():
        if hasattr(v, "item"):
            attrs[k] = v.item()
    return attrs


class _DeviceSpan:
    """A span's two timing events until ``export`` reads them, then its
    device interval ``(t0, t1)`` on the tracer's clock."""

    __slots__ = ("anchor", "start", "stop", "t0", "t1")

    def __init__(self, anchor, start):
        self.anchor, self.start, self.stop = anchor, start, None
        self.t0 = self.t1 = None


class _DeviceEvents:
    """Timing CUDA events for device spans, and the anchors that put them
    on the tracer's clock. Past ``limit`` stopped spans not yet read it
    reads them (a sync), so a tracer left on holds a bounded number."""

    def __init__(self, clock: Callable[[], float], limit: int):
        import torch
        self._cuda = torch.cuda
        self.clock = clock
        self.limit = limit
        self._lock = threading.Lock()  # threads stop spans into _pending
        self._pool: list = []
        self._pending: list = []       # stopped, not yet read
        self._anchor = None            # (event, clock) of the open session

    def _event(self):
        ev = self._pool.pop() if self._pool else \
            self._cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _mark(self, tries: int = 20, tight: float = 50e-6) -> tuple:
        """``(event, clock)``: sync; then record an event, wait for it and
        read the clock, also reading it before the record, until the two
        readings lie within ``tight`` seconds (at most ``tries`` times:
        under a profiler a record can take a millisecond); the tightest
        try, timed by its second reading."""
        self._cuda.synchronize()
        best = None
        for _ in range(tries):
            ev = self._cuda.Event(enable_timing=True)
            t0 = self.clock()
            ev.record()
            ev.synchronize()
            t1 = self.clock()
            if best is None or t1 - t0 < best[2] - best[1]:
                best = (ev, t0, t1)
            if t1 - t0 <= tight:
                break
        return best[0], best[2]

    def start(self) -> _DeviceSpan:
        if self._anchor is None:
            self._anchor = self._mark()
        return _DeviceSpan(self._anchor, self._event())

    def stop(self, ds: _DeviceSpan) -> None:
        ds.stop = self._event()
        with self._lock:
            self._pending.append(ds)
            full = len(self._pending) >= self.limit
        if full:
            self.resolve()

    def resolve(self) -> None:
        """Read every stopped span's events onto the clock, between its
        session's anchor and a mark taken now; the next device span opens
        a new session."""
        with self._lock:
            pending, self._pending = self._pending, []
            if not pending:
                return
            self._anchor = None
        end_ev, end_t = self._mark()
        scale: dict = {}
        for ds in pending:
            a_ev, a_t = ds.anchor
            if id(ds.anchor) not in scale:
                dev_s = a_ev.elapsed_time(end_ev) * 1e-3
                scale[id(ds.anchor)] = (end_t - a_t) / dev_s \
                    if dev_s > 0 else 1.0
            k = scale[id(ds.anchor)] * 1e-3
            ds.t0 = a_t + a_ev.elapsed_time(ds.start) * k
            ds.t1 = a_t + a_ev.elapsed_time(ds.stop) * k
            self._pool += (ds.start, ds.stop)
            ds.anchor = ds.start = ds.stop = None


class Tracer:
    """Ring-buffered span recorder. One per OS process.

    Spans are stored as ``(name, trace, span, parent, t0, t1, attrs, tid,
    device)`` tuples; ``t1 is None`` marks an instant annotation.
    ``export()`` returns dicts in ring order (oldest first) tagged with
    this tracer's process name. ``enabled``: True records always, False
    never, None while a ``torch.profiler`` session records.
    """

    def __init__(
        self,
        *,
        capacity: int = 1 << 15,
        clock: Optional[Callable[[], float]] = None,
        process: str = "main",
        enabled: Optional[bool] = True,
    ):
        self._enabled = enabled
        self.clock = clock or time.time
        self.process = process
        self.capacity = int(capacity)
        self._buf: Optional[list] = None  # allocated at the first span
        self._n = 0  # spans ever recorded (ring wraps past capacity)
        self._lock = threading.Lock()
        self._local = threading.local()  # .state: see _thread
        self._open: dict = {}  # id -> _Span, begun but not yet ended
        # pid-salted id base: spans from different processes never
        # collide when their exports are merged supervisor-side
        self._base = (os.getpid() & 0xFFFF) << 32
        self._ids = itertools.count(1)
        self._events: Optional[_DeviceEvents] = None

    @property
    def enabled(self) -> bool:
        """Whether a span begun now is recorded."""
        on = self._enabled
        return _profiling() if on is None else on

    # -- ids ----------------------------------------------------------

    def _new_id(self) -> int:
        return self._base | next(self._ids)

    def new_trace(self) -> int:
        """Fresh trace id for a new causal chain (one pusher flush)."""
        return self._new_id()

    def _thread(self) -> tuple:
        """This thread's stack of open (trace, span) and its native id,
        read once a thread (a system call)."""
        try:
            return self._local.state
        except AttributeError:
            state = self._local.state = ([], threading.get_native_id())
            return state

    def current(self) -> tuple:
        """(trace, span) of this thread's innermost open span, or
        (0, 0)."""
        stack = self._thread()[0]
        return stack[-1] if stack else (0, 0)

    @property
    def dropped(self) -> int:
        """Spans evicted by ring wrap-around."""
        return max(0, self._n - self.capacity)

    # -- recording ----------------------------------------------------

    def begin(self, name: str, *, trace: Optional[int] = None,
              parent: Optional[int] = None, device: bool = False, **attrs):
        """Open a span; close it with ``end`` or use as a context
        manager (``span`` is an alias). Unspecified trace/parent come
        from this thread's innermost open span, so nesting is implicit.
        ``device``: also time the device work the span enqueues on the
        current stream (on a card)."""
        if not self.enabled:
            return _NULL_SPAN
        stack, tid = self._thread()
        if trace is None:
            trace, ctx_parent = stack[-1] if stack else (0, 0)
            if parent is None:
                parent = ctx_parent
        elif parent is None:
            parent = 0
        sp = _Span()
        sp._tracer = self
        sp._stack = stack
        sp.name = name
        sp.trace = trace
        sp.parent = parent
        sp.id = self._new_id()
        sp.attrs = attrs or None
        sp.tid = tid
        stack.append((trace, sp.id))
        self._open[sp.id] = sp
        sp.t0 = self.clock()
        sp.dev = self._device().start() if device and _on_card() else None
        return sp

    span = begin

    def end(self, sp) -> None:
        if sp is _NULL_SPAN:
            return
        if sp.dev is not None:
            self._events.stop(sp.dev)
        t1 = self.clock()
        self._open.pop(sp.id, None)
        stack = sp._stack
        if stack:
            if stack[-1][1] == sp.id:              # common case: LIFO
                stack.pop()
            else:                                  # out-of-order end
                for i in range(len(stack) - 1, -1, -1):
                    if stack[i][1] == sp.id:
                        del stack[i]
                        break
        self._put(sp.name, sp.trace, sp.id, sp.parent, sp.t0, t1, sp.attrs,
                  sp.tid, sp.dev)

    def record(self, name: str, *, t0: float, t1: float, trace: int = 0,
               parent: int = 0, **attrs) -> int:
        """Record a completed span with explicit timestamps — used for
        spans reconstructed after the fact, like queue dwell measured
        from a record's ``t_push`` stamp at the consumer. Returns the
        new span id (0 when not recording)."""
        if not self.enabled:
            return 0
        sid = self._new_id()
        self._put(name, trace, sid, parent, t0, t1, attrs or None,
                  self._thread()[1], None)
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
                  attrs or None, self._thread()[1], None)
        return sid

    def _put(self, *entry) -> None:
        with self._lock:
            if self._buf is None:
                self._buf = [None] * self.capacity
            self._buf[self._n % self.capacity] = entry
            self._n += 1

    def _device(self) -> _DeviceEvents:
        if self._events is None:
            self._events = _DeviceEvents(self.clock, self.capacity)
        return self._events

    # -- export -------------------------------------------------------

    def export(self) -> list:
        """Span dicts, oldest first; a device span's interval on the
        tracer's clock as ``device: (t0, t1)``."""
        if self._events is not None:
            self._events.resolve()
        with self._lock:
            n, cap, buf = self._n, self.capacity, self._buf or []
            if n <= cap:
                entries = buf[:n]
            else:
                k = n % cap
                entries = buf[k:] + buf[:k]
        out = []
        for name, trace, sid, parent, t0, t1, attrs, tid, dev in entries:
            d = {"name": name, "proc": self.process, "trace": trace,
                 "span": sid, "parent": parent, "t0": t0, "t1": t1,
                 "tid": tid}
            if attrs:
                d["args"] = dict(_read_attrs(attrs))
            if dev is not None and dev.t0 is not None:
                d["device"] = (dev.t0, dev.t1)
            out.append(d)
        # still-open spans export too, clipped at "now" and flagged
        # partial — a SIGKILL mid-span (the pre-kill dump hook) must
        # not orphan children whose parent never reached the ring
        if self._open:
            t1 = self.clock()
            for sp in sorted(list(self._open.values()), key=lambda s: s.t0):
                d = {"name": sp.name, "proc": self.process,
                     "trace": sp.trace, "span": sp.id,
                     "parent": sp.parent, "t0": sp.t0, "t1": t1,
                     "tid": sp.tid,
                     "args": dict(_read_attrs(sp.attrs or {}),
                                  partial=True)}
                out.append(d)
        return out

    def clear(self) -> None:
        with self._lock:
            self._buf = None
            self._n = 0
        self._local = threading.local()
        self._open = {}


# -- module-global tracer ---------------------------------------------
# Follows torch.profiler; its ring is allocated at its first span, so an
# untraced process pays one tiny object. configure() swaps in another.

_tracer = Tracer(enabled=None)


def get_tracer() -> Tracer:
    return _tracer


def configure(*, enabled: Optional[bool] = True, capacity: int = 1 << 15,
              clock: Optional[Callable[[], float]] = None,
              process: str = "main") -> Tracer:
    """Install (and return) a fresh process-global tracer: ``enabled``
    True records always, False never (not even under a profiler), None
    while a ``torch.profiler`` session records."""
    global _tracer
    _tracer = Tracer(capacity=capacity, clock=clock, process=process,
                     enabled=enabled)
    return _tracer


def disable() -> Tracer:
    """Back to the default: recording only under a profiler."""
    return configure(enabled=None)


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


def main(argv=None) -> int:
    import argparse

    from repro_torch.obs import perfetto

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.trace",
        description="Summarize an exported Perfetto/Chrome trace: "
                    "per-stage p50/p99 and the slowest causal trees.")
    ap.add_argument("path", help="trace JSON written by obs.perfetto")
    ap.add_argument("--slowest", type=int, default=3, metavar="N",
                    help="how many slowest traces to dump (default 3)")
    args = ap.parse_args(argv)
    spans = perfetto.load_spans(args.path)
    if not spans:
        print(f"{args.path}: no spans")
        return 1
    print(summarize(spans, slowest=args.slowest))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
