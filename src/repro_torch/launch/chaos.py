"""Deterministic fault injection for the multi-process cluster runtime —
a copy of the reference's ``launch/chaos.py`` (same seeds, same plans).

A :class:`FaultPlan` is a seeded, fully serializable list of
:class:`FaultEvent`s — each names a target process (``master-0``,
``slave-1.0``), an instrumented code point, the driver step at which it
arms, and what happens there:

  * ``kill``  — the worker SIGKILLs *itself* (``os.kill(getpid(),
    SIGKILL)``) at the instrumented point: no cleanup, no flush, the
    closest a test can get to power loss for one process;
  * ``delay`` — the worker sleeps ``value`` seconds at the point
    (transport stall);
  * ``drop``  — a slave's poll returns without fetching (a dropped fetch
    response); the queue's consumer offsets don't move, so the next poll
    redelivers — the at-least-once window;
  * ``skew``  — the worker's sync clock runs ``value`` seconds ahead when
    stamping records, skewing the sync-lag metric downstream consumers
    compute from record timestamps.

Instrumented points (see ``launch/worker.py``):

  ========== ======= ====================================================
  point      role    crash window it exposes
  ========== ======= ====================================================
  mid_train  master  optimizer state mutated, ack never sent
  mid_flush  master  SOME partitions carry the flush's records, some don't
  mid_ckpt   master  part file half-written, manifest never committed
  pre_apply  slave   consumer offsets advanced in memory, records unapplied
  ========== ======= ====================================================

Determinism: events fire on exact (target, point, step) matches driven by
the supervisor's logical step counter — never wall clock — so a failing
seed replays exactly. The supervisor consumes each event when it observes
the death it caused and re-arms workers with only the *unfired* remainder
on respawn, so a kill does not re-fire while the recovered cluster replays
the very step that died.
"""

from __future__ import annotations

import json
import os
import random
import signal
import time
from dataclasses import asdict, dataclass, field
from typing import Optional

KILL_POINTS = ("mid_train", "mid_flush", "mid_ckpt", "pre_apply")
MASTER_POINTS = ("mid_train", "mid_flush", "mid_ckpt")
SLAVE_POINTS = ("pre_apply",)


@dataclass(frozen=True)
class FaultEvent:
    target: str               # ProcSlot.name, e.g. "master-0", "slave-1.0"
    point: str                # one of KILL_POINTS
    step: int                 # driver step at which the event fires
    kind: str = "kill"        # kill | delay | drop | skew
    value: float = 0.0        # delay/skew seconds (unused for kill/drop)

    def matches(self, target: str, point: str, step: int) -> bool:
        return (self.target == target and self.point == point
                and self.step == step)


@dataclass
class FaultPlan:
    """Seeded schedule of fault events, stable under (de)serialization."""

    seed: int
    events: list[FaultEvent] = field(default_factory=list)

    @classmethod
    def generate(cls, seed: int, *, steps: int,
                 masters: list[str], slaves: list[str],
                 kills: int = 2, delays: int = 1, drops: int = 1,
                 skews: int = 0, skew: float = 5.0,
                 delay: float = 0.05) -> "FaultPlan":
        """Draw a deterministic plan: ``kills`` process kills spread over
        master points and slave pre_apply, plus transport delays/drops and
        clock skews. Same (seed, shape) args -> identical plan, on any
        host. Kill steps avoid step 0 (the bootstrap checkpoint) and the
        final step (so every run has a post-recovery tail to assert on)."""
        rng = random.Random(seed)
        events: list[FaultEvent] = []
        step_lo, step_hi = 1, max(1, steps - 2)
        for _ in range(kills):
            if slaves and rng.random() < 0.3:
                events.append(FaultEvent(rng.choice(slaves), "pre_apply",
                                         rng.randint(step_lo, step_hi)))
            else:
                events.append(FaultEvent(rng.choice(masters),
                                         rng.choice(list(MASTER_POINTS)),
                                         rng.randint(step_lo, step_hi)))
        for _ in range(delays):
            who = rng.choice(masters + slaves)
            pt = "pre_apply" if who in slaves else "mid_flush"
            events.append(FaultEvent(who, pt,
                                     rng.randint(step_lo, step_hi),
                                     kind="delay", value=delay))
        for _ in range(drops):
            if slaves:
                events.append(FaultEvent(rng.choice(slaves), "pre_apply",
                                         rng.randint(step_lo, step_hi),
                                         kind="drop"))
        for _ in range(skews):
            events.append(FaultEvent(rng.choice(masters), "mid_flush",
                                     rng.randint(step_lo, step_hi),
                                     kind="skew", value=skew))
        events.sort(key=lambda e: (e.step, e.target, e.point, e.kind))
        return cls(seed=seed, events=events)

    # -- (de)serialization (supervisor <-> workers, CI repro) ------------
    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "events": [asdict(e) for e in self.events]},
                          indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        return cls(seed=d["seed"],
                   events=[FaultEvent(**e) for e in d["events"]])

    def for_target(self, target: str) -> list[FaultEvent]:
        return [e for e in self.events if e.target == target]

    def kills(self) -> list[FaultEvent]:
        return [e for e in self.events if e.kind == "kill"]


class FaultHooks:
    """Worker-side executor of the events armed for one process. The
    worker calls ``check(point, step)`` at every instrumented point; a
    matching event fires its effect. ``kill`` never returns."""

    def __init__(self, target: str,
                 events: Optional[list[FaultEvent]] = None):
        self.target = target
        self.events = list(events or [])
        self.fired: list[FaultEvent] = []
        self.skew = 0.0           # cumulative clock skew (seconds)
        # observability hook: called with each event just BEFORE its
        # effect executes. A kill destroys the process (and any
        # in-memory trace ring) instantly, so this is the only moment a
        # fault annotation / pre-kill span dump can be recorded —
        # launch/worker.py wires it to the tracer.
        self.on_fire = None

    def arm(self, events: list[FaultEvent]) -> None:
        self.events = list(events)

    def pending(self, point: str, step: int,
                kind: Optional[str] = None) -> Optional[FaultEvent]:
        for e in self.events:
            if e.matches(self.target, point, step) and \
                    (kind is None or e.kind == kind):
                return e
        return None

    def check(self, point: str, step: int) -> bool:
        """Fire every armed event matching (point, step). Returns True
        when a ``drop`` fired (the caller skips its fetch). A ``kill``
        SIGKILLs this process — no return, no cleanup."""
        dropped = False
        for e in list(self.events):
            if not e.matches(self.target, point, step):
                continue
            self.events.remove(e)
            self.fired.append(e)
            if self.on_fire is not None:
                self.on_fire(e)
            if e.kind == "delay":
                time.sleep(e.value)
            elif e.kind == "skew":
                self.skew += e.value
            elif e.kind == "drop":
                dropped = True
            elif e.kind == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
        return dropped

    def now(self, now: float) -> float:
        """The worker's (possibly skewed) view of the sync clock."""
        return now + self.skew
