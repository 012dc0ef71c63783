"""Serving: the paged continuous-batching engine with BitStopper decode,
seeded sampling, oversubscription with preemption, and speculative
decoding."""

from repro_torch.serving.engine import (  # noqa: F401
    PagedEngine,
    Request,
    ServeConfig,
)
from repro_torch.serving.kv_pool import KVBlockPool  # noqa: F401
from repro_torch.serving.sampling import (  # noqa: F401
    prng_key,
    sample_tokens,
)
from repro_torch.serving.speculative import (  # noqa: F401
    DraftModelDrafter,
    Drafter,
    NGramDrafter,
    make_drafter,
)
