"""Atomic crash snapshots and the persistent prefix store (the serving
half of the reference's ``checkpoint/`` package)."""

from repro_torch.checkpoint.store import (  # noqa: F401
    gc_staging, latest_step, list_prefix_records, load_prefix_record,
    load_snapshot, prefix_record_name, prefix_store_bytes,
    save_prefix_record, save_snapshot,
)
