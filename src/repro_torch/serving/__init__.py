"""Serving: the paged continuous-batching engine with BitStopper (or
dense) decode, the contiguous and static baselines,
seeded sampling, oversubscription with preemption, speculative decoding,
crash snapshots with the deterministic chaos harness, the KV memory
hierarchy (swap-to-host preemption, the persistent prefix store), and the
engine API (prefill, extract, insert, generate_step) that the async front
door in ``serving/frontdoor`` drives."""

from repro_torch.serving.chaos import (  # noqa: F401
    CheckpointInterrupted,
    DrafterFault,
    FaultEvent,
    FaultInjector,
    FaultPlan,
    HostCrash,
    KernelFault,
    serve_with_chaos,
)
from repro_torch.serving.engine import (  # noqa: F401
    ContinuousBatchingEngine,
    InsufficientBlocks,
    PagedEngine,
    Prefix,
    Request,
    ServeConfig,
    StaticBucketEngine,
)
from repro_torch.serving.kv_pool import KVBlockPool, SwapPool  # noqa: F401
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
