"""Deterministic synthetic token streams (counterpart of ``repro/data``)."""
from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset,
                                       host_shard_slice, make_train_iterator,
                                       prefetch)

__all__ = ["DataConfig", "SyntheticLMDataset", "make_train_iterator",
           "prefetch", "host_shard_slice"]
