"""Serving: the paged continuous-batching engine with BitStopper decode."""

from repro_torch.serving.engine import (  # noqa: F401
    PagedEngine,
    Request,
    ServeConfig,
)
from repro_torch.serving.kv_pool import KVBlockPool  # noqa: F401
