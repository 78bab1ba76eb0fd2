"""AdamW over the adapter leaves only, and the cross-pod gradient
compression (counterpart of ``repro/optim``)."""
from repro_torch.optim.adamw import (OptimizerConfig, adamw_init,
                                     adamw_update, clip_by_global_norm,
                                     cosine_warmup_schedule, global_norm)
from repro_torch.optim.compression import (compress_bf16, cross_pod_sync,
                                           decompress_bf16,
                                           init_error_feedback,
                                           int8_ef_compress,
                                           int8_ef_decompress)

__all__ = ["OptimizerConfig", "adamw_init", "adamw_update",
           "cosine_warmup_schedule", "clip_by_global_norm", "global_norm",
           "compress_bf16", "decompress_bf16", "init_error_feedback",
           "int8_ef_compress", "int8_ef_decompress", "cross_pod_sync"]
