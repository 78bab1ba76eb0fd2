"""Atomic adapter + optimizer checkpoints and the training loop's fault
hooks (counterpart of ``repro/checkpoint``)."""
from repro_torch.checkpoint.fault import (Heartbeat, PreemptionHandler,
                                          StragglerMonitor)
from repro_torch.checkpoint.store import (CheckpointConfig, garbage_collect,
                                          latest_step, restore_checkpoint,
                                          save_checkpoint)

__all__ = ["CheckpointConfig", "save_checkpoint", "restore_checkpoint",
           "latest_step", "garbage_collect", "PreemptionHandler",
           "Heartbeat", "StragglerMonitor"]
