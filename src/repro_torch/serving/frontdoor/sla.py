"""Wall-clock to tick SLA mapping for the async front door.

Counterpart of ``repro/serving/frontdoor/sla.py``.  The engine's QoS
(deadlines, shedding, SLO-aware victim choice) is indexed by ticks, and
``serving/`` reads no wall clock, so a client's "answer within 300 ms" is
translated at the boundary.  :class:`SlaMapper` does it with two
ingredients, both injected:

* a clock (``repro_torch.runtime.clock``) whose ``granularity`` quantizes
  client deadlines up to multiples it can resolve, so a deadline never
  rounds below what the client asked for;
* a tick-duration estimate: an EMA over observed engine ticks (the
  ``StragglerPolicy`` EMA the watchdog uses), ``default_tick_s`` until
  observations arrive.  With a ``ManualClock`` that never advances the
  estimate stays at ``default_tick_s`` and the mapping is a pure function.
"""

from __future__ import annotations

import math

from repro_torch.runtime.fault_tolerance import StragglerPolicy


class SlaMapper:
    """Maps wall-clock deadlines onto engine-tick deadlines.

    ``ticks_for(deadline_s)`` is ``deadline_s`` quantized up to a multiple
    of the clock granularity, divided by the estimated tick duration,
    floored at one tick.  The division rounds down (a partial tick past
    the deadline is already late), but the quantization comes first, so a
    sub-granularity deadline still buys one full granule of service."""

    def __init__(self, granularity: float = 1e-3,
                 default_tick_s: float = 1e-2,
                 ema_alpha: float = 0.1):
        if granularity <= 0.0:
            raise ValueError(f"granularity must be > 0, got {granularity}")
        if default_tick_s <= 0.0:
            raise ValueError(
                f"default_tick_s must be > 0, got {default_tick_s}")
        self.granularity = granularity
        self.default_tick_s = default_tick_s
        self._policy = StragglerPolicy(ema_alpha=ema_alpha)
        self.observed_ticks = 0

    @property
    def tick_estimate(self) -> float:
        """The EMA once ticks have been observed, else the default."""
        ema = self._policy.ema
        return ema if ema is not None else self.default_tick_s

    def observe_tick(self, dt: float) -> None:
        """Feed one measured engine-tick duration (from the injected
        clock).  Durations <= 0 are dropped: a ManualClock that never
        advances keeps the mapper on ``default_tick_s``."""
        if dt <= 0.0:
            return
        self._policy.observe(dt)
        self.observed_ticks += 1

    def quantize(self, deadline_s: float) -> float:
        """Round a wall-clock deadline up to a granularity multiple."""
        g = self.granularity
        return math.ceil(deadline_s / g - 1e-12) * g

    def ticks_for(self, deadline_s: float) -> int:
        """Tick budget a wall-clock deadline buys at the current estimate.
        Always >= 1: the engine needs a positive deadline, and admission
        itself costs a tick."""
        if deadline_s <= 0.0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        q = self.quantize(deadline_s)
        return max(1, int(q / self.tick_estimate + 1e-9))
