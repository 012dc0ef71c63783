"""Data pipeline: a synthetic LM stream with host prefetch and shards."""

from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig, SyntheticLMDataset, shard_rows,
)
