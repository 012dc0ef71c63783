"""The async front door: asyncio admission and per-request token streaming
over the engine API.

Counterpart of ``repro/serving/frontdoor/door.py``.  ``AsyncFrontDoor``
owns the boundary between asynchronous clients and the deterministic,
single-threaded engine tick loop:

* **Identity at arrival.**  ``submit()`` fixes the request's rid when it
  arrives.  Sampling keys are ``fold_in(fold_in(seed, rid), n)``, a pure
  function of (seed, rid, token index), so the fair admission below may
  reorder admission without changing a served token: streams equal the
  synchronous trace.
* **Fair admission.**  Pending requests queue per SLO class; before each
  tick the door drains them into the engine round-robin over ``strict ->
  standard -> besteffort`` (one from each non-empty class per cycle), so a
  burst of best-effort work cannot starve strict arrivals.  The order
  handed to the engine is kept in ``admission_log``.
* **Streaming.**  ``stream(rid)`` is an async iterator fed by a diff of
  the request registry after every tick: committed tokens go to a
  per-request queue, and a terminal state (finish, deadline truncation,
  shed) closes it.  A stream attached after a restart first replays
  everything already generated.
* **Wall-clock SLAs.**  A ``deadline_s`` on submit maps to engine ticks
  through the :class:`~repro_torch.serving.frontdoor.sla.SlaMapper`, fed
  with tick durations measured on the injected clock.
* **Graceful shutdown.**  ``shutdown("drain")`` stops admissions and serves
  everything accepted to the end.  ``shutdown("snapshot")`` hands pending
  submissions to the engine, stops the loop and persists
  ``PagedEngine.snapshot()`` through the checkpoint store; ``start()`` on
  a fresh door reclaims staging orphans (``gc_staging``), restores the
  newest snapshot, and the interrupted streams replay from token zero.

The backend is anything with the engine protocol: a ``PagedEngine``
(colocated) or a ``DisaggController`` (``serving/frontdoor/disagg.py``).
"""

from __future__ import annotations

import asyncio
import collections

import numpy as np

from repro_torch.checkpoint.store import (gc_staging, latest_step,
                                          load_snapshot, save_snapshot)
from repro_torch.serving.engine import Request
from repro_torch.serving.frontdoor.sla import SlaMapper

_DONE = object()          # stream sentinel: the request reached its end
_INTERRUPTED = object()   # stream sentinel: the door stopped for a snapshot

_SLO_ORDER = ("strict", "standard", "besteffort")


class AsyncFrontDoor:
    """Asyncio serving front door over a deterministic engine backend."""

    def __init__(self, backend, *, clock=None, sla: SlaMapper | None = None,
                 snapshot_dir: str | None = None, seed: int = 0):
        if snapshot_dir is not None and not hasattr(backend, "snapshot"):
            raise ValueError(
                "snapshot_dir needs a snapshot-capable backend "
                "(PagedEngine); the disaggregated controller drains "
                "instead")
        self.backend = backend
        self.clock = clock
        self.sla = sla if sla is not None else SlaMapper()
        self.snapshot_dir = snapshot_dir
        self.seed = seed
        self._pending = {cls: collections.deque() for cls in _SLO_ORDER}
        self._queues: dict[int, asyncio.Queue] = {}
        self._published: dict[int, int] = {}
        self._done: set[int] = set()
        self.interrupted: set[int] = set()
        self._next_rid = max(backend.requests, default=-1) + 1
        self._wake = asyncio.Event()
        self._stop = False
        self._drain = False
        self._running = False
        self.restored = False
        self.ticks_run = 0                     # engine ticks this door drove
        self.admission_log: list[int] = []     # rids in engine-submit order
        self.first_token_tick: dict[int, int] = {}
        self.finish_tick: dict[int, int] = {}

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> bool:
        """Prepare the backend: reclaim snapshot staging orphans and
        restore the newest snapshot if there is one (returns True: the
        in-flight streams replay and continue), else begin afresh under
        ``seed``."""
        if self.snapshot_dir is not None:
            gc_staging(self.snapshot_dir)
            if latest_step(self.snapshot_dir) is not None:
                state, _ = load_snapshot(self.snapshot_dir)
                self.backend.restore(state)
                self._next_rid = max(self.backend.requests, default=-1) + 1
                self.restored = True
                return True
        self.backend.begin(self.seed)
        return False

    def submit(self, prompt, max_new_tokens: int = 32,
               slo: str = "standard", deadline_s: float | None = None,
               deadline_ticks: int | None = None) -> int:
        """Accept a request; returns its rid (the stream handle).  The rid
        is fixed now, in arrival order; admission may reorder later without
        changing tokens."""
        if self._stop or self._drain:
            raise RuntimeError("front door is shutting down")
        if slo not in _SLO_ORDER:
            raise ValueError(
                f"slo must be strict|standard|besteffort, got {slo!r}")
        if deadline_s is not None:
            if deadline_ticks is not None:
                raise ValueError(
                    "give deadline_s or deadline_ticks, not both")
            deadline_ticks = self.sla.ticks_for(deadline_s)
        req = Request(prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, slo=slo,
                      deadline_ticks=deadline_ticks, rid=self._next_rid)
        self._next_rid += 1
        self._pending[slo].append(req)
        self._queues[req.rid] = asyncio.Queue()
        self._published[req.rid] = 0
        self._wake.set()
        return req.rid

    async def run(self) -> None:
        """The engine loop: admit pending work fairly, tick the backend,
        publish committed tokens to the streams.  Returns when a drain
        completes or on a stop, persisting a snapshot on the way out when
        stopping with a ``snapshot_dir``."""
        if self._running:
            raise RuntimeError("run() is already active")
        self._running = True
        try:
            while not self._stop:
                self._admit_pending()
                self._publish()
                if self.backend.pending():
                    if self.clock is not None:
                        t0 = self.clock()
                        self.backend.step()
                        self.sla.observe_tick(self.clock() - t0)
                    else:
                        self.backend.step()
                    self.ticks_run += 1
                    self._publish()
                    await asyncio.sleep(0)
                elif self._drain:
                    break
                else:
                    self._wake.clear()
                    await self._wake.wait()
        finally:
            self._running = False
            if self._stop and self.snapshot_dir is not None:
                self._snapshot()
            self._finalize_streams()

    def shutdown(self, mode: str = "drain") -> None:
        """Begin a graceful shutdown.  ``"drain"``: refuse new submissions
        and serve everything accepted to the end.  ``"snapshot"``: hand
        pending submissions to the engine so that the snapshot owns them,
        stop the loop now and persist the engine's state; open streams end
        marked interrupted, and a restarted door resumes them.  The caller
        awaits its ``run()`` task."""
        if mode not in ("drain", "snapshot"):
            raise ValueError(f"mode must be drain|snapshot, got {mode!r}")
        if mode == "drain":
            self._drain = True
        else:
            self._admit_pending()
            self._stop = True
        self._wake.set()

    # ------------------------------------------------------------------
    # streams
    # ------------------------------------------------------------------

    async def stream(self, rid: int):
        """Iterate the request's tokens as the engine commits them.
        Tokens generated before attachment (or before a restart) replay
        first, so a reconnecting client sees the whole stream."""
        q = self._queues.get(rid)
        if q is None:
            if rid not in self.backend.requests:
                raise KeyError(f"unknown rid {rid}")
            q = self._queues[rid] = asyncio.Queue()
            self._published[rid] = 0
            self._wake.set()
        while True:
            tok = await q.get()
            if tok is _DONE or tok is _INTERRUPTED:
                return
            yield tok

    def result(self, rid: int) -> Request:
        """The request (tokens and terminal state) for a rid."""
        for cls in _SLO_ORDER:
            for req in self._pending[cls]:
                if req.rid == rid:
                    return req
        return self.backend.requests[rid]

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _admit_pending(self) -> None:
        """Drain door-pending requests into the engine: one per non-empty
        SLO class per cycle, strict first."""
        while any(self._pending.values()):
            for cls in _SLO_ORDER:
                if self._pending[cls]:
                    req = self._pending[cls].popleft()
                    self.backend.submit(req)
                    self.admission_log.append(req.rid)

    def _publish(self) -> None:
        """Diff the request registry against what each stream has seen and
        push the difference; a terminal state closes the stream."""
        for rid, req in self.backend.requests.items():
            if rid in self._done:
                continue
            q = self._queues.get(rid)
            if q is None:
                q = self._queues[rid] = asyncio.Queue()
                self._published[rid] = 0
            n0 = self._published[rid]
            new = req.generated[n0:]
            if new and rid not in self.first_token_tick:
                self.first_token_tick[rid] = self.ticks_run
            for tok in new:
                q.put_nowait(int(tok))
            self._published[rid] = len(req.generated)
            if req.finished_step >= 0 or req.shed_reason is not None:
                self.finish_tick.setdefault(rid, self.ticks_run)
                q.put_nowait(_DONE)
                self._done.add(rid)

    def _snapshot(self) -> None:
        save_snapshot(self.backend.snapshot(), self.snapshot_dir,
                      int(self.backend.ticks))

    def _finalize_streams(self) -> None:
        for rid, q in self._queues.items():
            if rid not in self._done:
                self.interrupted.add(rid)
                q.put_nowait(_INTERRUPTED)
