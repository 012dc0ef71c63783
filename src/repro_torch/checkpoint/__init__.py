"""Atomic crash snapshots (the serving half of the reference's
``checkpoint/`` package)."""

from repro_torch.checkpoint.store import (  # noqa: F401
    gc_staging, latest_step, load_snapshot, save_snapshot,
)
