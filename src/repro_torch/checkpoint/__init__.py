"""Atomic pytree checkpoints, crash snapshots and the persistent prefix
store."""

from repro_torch.checkpoint.store import (  # noqa: F401
    CheckpointManager, gc_staging, latest_step, list_prefix_records,
    load_checkpoint, load_prefix_record, load_snapshot, prefix_record_name,
    prefix_store_bytes, save_checkpoint, save_prefix_record, save_snapshot,
)
