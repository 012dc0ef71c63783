"""Cluster runtime: failure detection, elastic re-meshing decisions,
stragglers, the serving stuck-tick watchdog, and injectable clocks."""

from repro_torch.runtime.clock import ManualClock, SystemClock  # noqa: F401
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    ClusterMonitor, ElasticMeshManager, EngineWatchdog, StragglerPolicy,
    StuckTickError,
)
