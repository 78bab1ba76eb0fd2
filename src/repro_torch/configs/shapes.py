"""Assigned input shapes (per-arch shape set for the LM-family pool); the
port's own copy of ``repro/configs/shapes.py``.

  train_4k     seq 4096  × global_batch 256   — training step
  prefill_32k  seq 32768 × global_batch 32    — inference prefill
  decode_32k   seq 32768 × global_batch 128   — one-token decode, 32k cache
  long_500k    seq 524288 × global_batch 1    — long-context decode
                 (SSM/hybrid only; quadratic-attention archs skip it)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Reduced shapes for CPU smoke testing (same kinds, tiny sizes).
SMOKE_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 64, 2, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 128, 2, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 128, 2, "decode"),
    "long_500k": ShapeSpec("long_500k", 256, 1, "decode"),
}


def applicable_shapes(mcfg) -> list[str]:
    """long_500k only runs for sub-quadratic (SSM/hybrid) families."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if mcfg.ssm or mcfg.attn_period:
        names.append("long_500k")
    return names
