"""AdamW over the adapter leaves only (counterpart of ``repro/optim``)."""
from repro_torch.optim.adamw import (OptimizerConfig, adamw_init,
                                     adamw_update, clip_by_global_norm,
                                     cosine_warmup_schedule, global_norm)

__all__ = ["OptimizerConfig", "adamw_init", "adamw_update",
           "cosine_warmup_schedule", "clip_by_global_norm", "global_norm"]
