"""Async serving front door.

Counterpart of ``repro/serving/frontdoor``.  The only corner of
``serving/`` that touches asyncio: the engine itself stays a
deterministic, synchronous tick loop, and everything event-driven lives
behind this package's door.
"""

from repro_torch.serving.frontdoor.disagg import (  # noqa: F401
    DisaggController, TransferQueue,
)
from repro_torch.serving.frontdoor.door import AsyncFrontDoor  # noqa: F401
from repro_torch.serving.frontdoor.sla import SlaMapper  # noqa: F401
