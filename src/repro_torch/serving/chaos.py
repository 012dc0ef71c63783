"""Deterministic fault injection and the crash/restore harness for
serving.

Counterpart of ``repro/serving/chaos.py``.  Every fault is a pure function
of the scripted plan and the engine's tick counter: no wall clock, no
ambient randomness.  A :class:`FaultPlan` is a list of ``(kind, tick)``
events (scripted or derived from a seed); a :class:`FaultInjector` fires
each event at the first consultation of its kind at or after its tick,
exactly once.  Replaying a trace under the same plan reproduces the same
faults at the same points, so tests can require identical tokens across a
fault storm.

Fault kinds and where they bite:

* ``pool_dry``: a mid-decode block claim is forced to preempt a victim
  although the pool has room (``PagedEngine._claim_block``); a
  speculative draft-block claim truncates the draft instead.
* ``kernel_fail``: the decode or verify kernel raises :class:`KernelFault`;
  the engine's circuit breaker switches to the plain oracle, which gives
  the same tokens, and runs the same tick again.
* ``drafter_fail``: the speculative drafter dies; the tick decodes plain.
* ``checkpoint_interrupt``: a snapshot write dies after staging, before
  the atomic promote; the store never exposes it and GC reclaims it.
* ``swap_fail``: consulted by the swap-to-host tier, which the port does
  not have yet (ROADMAP A7.3); until then such an event stays unfired, as
  it does in the reference when swap is off.
* ``crash``: the host dies between ticks; the harness builds a fresh
  engine and restores the latest snapshot.  Served tokens must equal an
  undisturbed run's.

The injector lives in the harness, outside the engine, so it survives a
``crash``: ticks replayed after a restore do not fire consumed events
again.

Nothing in ``serving/`` reads a wall clock; the engine keys every fault,
deadline and snapshot on its tick counter.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

KINDS = ("pool_dry", "kernel_fail", "drafter_fail",
         "checkpoint_interrupt", "swap_fail", "crash")


class KernelFault(RuntimeError):
    """An injected failure of the decode or verify kernel.  Caught by the
    engine's circuit breaker, which switches to the plain oracle and runs
    the tick again; tokens never change."""


class DrafterFault(RuntimeError):
    """Speculative drafter failure: the tick decodes plain; no tokens are
    lost."""


class HostCrash(RuntimeError):
    """Simulated whole-host death between scheduler ticks.  Raised by the
    harness and never caught by the engine: recovery is a fresh engine and
    :meth:`PagedEngine.restore` from the latest snapshot."""


class CheckpointInterrupted(RuntimeError):
    """A snapshot write was killed after staging but before the atomic
    promote (``checkpoint/store.py``).  The previous snapshot stays the
    visible latest; the staging orphan is GC'd."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault: fires at the first consultation of ``kind`` at
    tick >= ``tick``, then is consumed."""
    kind: str
    tick: int

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"kinds are {KINDS}")
        if self.tick < 0:
            raise ValueError(f"fault tick must be >= 0, got {self.tick}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable scripted sequence of faults: plain (kind, tick) data,
    with no time of day or randomness at fire time."""
    events: tuple[FaultEvent, ...] = ()

    @classmethod
    def scripted(cls, events) -> "FaultPlan":
        """Build from ``(kind, tick)`` pairs (or FaultEvents)."""
        evs = tuple(e if isinstance(e, FaultEvent) else FaultEvent(*e)
                    for e in events)
        return cls(events=evs)

    @classmethod
    def from_seed(cls, seed: int, n_events: int, max_tick: int,
                  kinds=KINDS) -> "FaultPlan":
        """``n_events`` faults with kinds and ticks drawn from a seeded
        ``np.random.default_rng``: the same plan as the reference's for the
        same arguments."""
        rng = np.random.default_rng(seed)
        kinds = tuple(kinds)
        evs = tuple(FaultEvent(kinds[int(rng.integers(len(kinds)))],
                               int(rng.integers(max_tick + 1)))
                    for _ in range(n_events))
        return cls(events=evs)

    def to_json(self) -> str:
        return json.dumps([[e.kind, e.tick] for e in self.events])

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.scripted(json.loads(text))


class FaultInjector:
    """Consumes a :class:`FaultPlan` against the engine's tick counter.

    ``fire(kind, tick)`` returns True iff an unconsumed event of ``kind``
    has armed (``event.tick <= tick``); the event is then consumed and
    logged.  The engine's schedule fixes the order of consultations, so
    the log is a pure function of (plan, trace)."""

    def __init__(self, plan: FaultPlan | None = None):
        self.plan = plan or FaultPlan()
        self._pending: list[FaultEvent] = sorted(
            self.plan.events, key=lambda e: (e.tick, e.kind))
        self.fired: list[tuple[str, int, int]] = []  # (kind, armed, fired-at)

    def fire(self, kind: str, tick: int) -> bool:
        for i, ev in enumerate(self._pending):
            if ev.kind == kind and ev.tick <= tick:
                del self._pending[i]
                self.fired.append((kind, ev.tick, tick))
                return True
        return False

    def pending(self) -> list[tuple[str, int]]:
        return [(e.kind, e.tick) for e in self._pending]

    def report(self) -> dict:
        by_kind: dict[str, int] = {}
        for kind, _, _ in self.fired:
            by_kind[kind] = by_kind.get(kind, 0) + 1
        return {"fired": list(self.fired),
                "fired_by_kind": by_kind,
                "unfired": self.pending()}


def serve_with_chaos(make_engine, requests, seed: int = 0,
                     plan: FaultPlan | None = None,
                     snapshot_dir: str | None = None,
                     snapshot_every: int | None = None):
    """Drive a serving trace under a fault plan, with crash recovery.

    ``make_engine`` builds a fresh :class:`PagedEngine` (a crash destroys
    the old one, device KV and all).  Requests are submitted up front; a
    snapshot is taken at once (so a crash at any tick has something to
    restore) and then every ``snapshot_every`` ticks (default: the
    engine's ``ServeConfig.snapshot_every``).  A ``crash`` raises
    :class:`HostCrash` between ticks; recovery builds a new engine and
    restores the latest snapshot: tokens generated so far come from the
    snapshot, in-flight requests requeue through the lossless resume path,
    and the continuation samples under the same (seed, rid, token index)
    keys.

    Returns ``(requests, report)``: the engine's request objects by rid
    (after a crash these are restored objects, not the caller's) and the
    fault, snapshot and restore accounting."""
    from repro_torch.checkpoint.store import (gc_staging, load_snapshot,
                                              save_snapshot)

    injector = FaultInjector(plan)
    engine = make_engine()
    engine.chaos = injector
    every = (engine.scfg.snapshot_every if snapshot_every is None
             else snapshot_every)
    for r in requests:
        engine.submit(r)
    engine.begin(seed)
    report = {"crashes": 0, "restores": 0, "snapshots_taken": 0,
              "snapshots_interrupted": 0, "staging_reclaimed": 0}

    def take_snapshot():
        if snapshot_dir is None:
            return
        state = engine.snapshot()

        def interrupt():
            if injector.fire("checkpoint_interrupt", engine.ticks):
                raise CheckpointInterrupted(
                    f"snapshot write killed at tick {engine.ticks}")

        try:
            save_snapshot(state, snapshot_dir, step=engine.ticks,
                          interrupt=interrupt)
            report["snapshots_taken"] += 1
        except CheckpointInterrupted:
            report["snapshots_interrupted"] += 1
            # The harness is the only writer, so the orphan is reclaimable
            # at once.
            report["staging_reclaimed"] += len(
                gc_staging(snapshot_dir, grace=0.0))

    take_snapshot()
    while engine.pending():
        try:
            if injector.fire("crash", engine.ticks):
                raise HostCrash(f"host died at tick {engine.ticks}")
            engine.step()
        except HostCrash:
            report["crashes"] += 1
            if snapshot_dir is None:
                raise          # nothing to restore from: the crash is fatal
            engine = make_engine()
            engine.chaos = injector
            state, _ = load_snapshot(snapshot_dir)
            engine.restore(state)
            report["restores"] += 1
            continue
        if (snapshot_dir is not None and every
                and engine.ticks % every == 0):
            take_snapshot()

    out = [engine.requests[rid] for rid in sorted(engine.requests)]
    report.update(injector.report())
    report["engine_counters"] = dict(engine.counters)
    return out, report
