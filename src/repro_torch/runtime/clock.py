"""Injectable clocks for the serving stack.

Counterpart of ``repro/runtime/clock.py``.  ``serving/`` reads no wall
clock: anything that needs real time gets a clock injected from here, the
pattern ``EngineWatchdog`` uses.  Two implementations share the one-method
protocol (a zero-argument callable returning monotonic seconds):

* :class:`SystemClock` wraps ``time.monotonic`` for production.
* :class:`ManualClock` is a deterministic clock the caller advances
  explicitly; tests use it so that everything downstream of a clock is a
  pure function of the calls made.

Both expose ``granularity``: the coarsest interval the clock can
meaningfully resolve.
"""

from __future__ import annotations

import time


class SystemClock:
    """Monotonic wall clock (production).  ``granularity`` is the interval
    below which scheduling jitter makes finer deadlines meaningless, not the
    hardware timer resolution."""

    def __init__(self, granularity: float = 1e-3):
        if granularity <= 0.0:
            raise ValueError(f"granularity must be > 0, got {granularity}")
        self.granularity = granularity

    def __call__(self) -> float:
        return time.monotonic()


class ManualClock:
    """Deterministic clock: time moves only when the caller calls
    :meth:`advance`."""

    def __init__(self, start: float = 0.0, granularity: float = 1e-3):
        if granularity <= 0.0:
            raise ValueError(f"granularity must be > 0, got {granularity}")
        self.now = float(start)
        self.granularity = granularity

    def advance(self, dt: float) -> float:
        if dt < 0.0:
            raise ValueError(f"time cannot move backwards (dt={dt})")
        self.now += dt
        return self.now

    def __call__(self) -> float:
        return self.now
