"""Model configuration (counterpart of ``repro/models/config.py``) with
torch dtypes.

The dataclass keeps the reference's field names for what this slice runs:
the dense attention archs. The flags that mark the other archs (MoE, SSM,
hybrid, modality frontends) stay so that :func:`check_supported` can
refuse them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0               # 0 → d_model // num_heads
    # --- attention ---
    qk_norm: bool = False           # not ported yet (see check_supported)
    qkv_bias: bool = False
    pos_mode: str = "rope"          # rope (this slice)
    rope_theta: float = 10000.0
    attn_chunk: int | None = None   # online-softmax KV chunk (None = dense)
    # --- mlp ---
    mlp_kind: str = "swiglu"
    norm_kind: str = "rms"
    # --- MoE / SSM / hybrid (not ported yet; see check_supported) ---
    moe: bool = False
    ssm: bool = False
    attn_period: int = 0
    # --- misc ---
    norm_eps: float = 1e-5
    frontend: str | None = None
    dtype: Any = torch.bfloat16
    # remat: "none" | "layer" (training recomputes each layer's internals
    # in the backward and keeps only the layer boundaries and the norms)
    remat: str = "layer"

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def period(self) -> int:
        """Length of the repeating layer pattern (the stacked unit): 1 for
        the dense archs this slice runs."""
        return 1

    @property
    def n_scan(self) -> int:
        return self.num_layers // self.period


def check_supported(mcfg: ModelConfig) -> None:
    """Raise NotImplementedError for the archs later slices port."""
    if mcfg.moe or mcfg.ssm or mcfg.attn_period:
        raise NotImplementedError(
            f"{mcfg.name}: MoE and Mamba/hybrid stacks come with a later "
            f"slice of the port (with the selective-scan kernel)")
    if mcfg.frontend is not None:
        raise NotImplementedError(
            f"{mcfg.name}: modality frontends ({mcfg.frontend}) are not "
            f"ported yet")
    if mcfg.pos_mode != "rope":
        raise NotImplementedError(
            f"{mcfg.name}: pos_mode {mcfg.pos_mode!r} is not ported yet "
            f"(this slice has standard RoPE)")
    if mcfg.remat not in ("none", "layer"):
        raise ValueError(f"{mcfg.name}: unknown remat {mcfg.remat!r} "
                         f"(expected 'none' or 'layer')")
    for field, ported in (("mlp_kind", "swiglu"), ("norm_kind", "rms"),
                          ("qk_norm", False)):
        if getattr(mcfg, field) != ported:
            raise NotImplementedError(
                f"{mcfg.name}: {field}={getattr(mcfg, field)!r} is not "
                f"ported yet")
