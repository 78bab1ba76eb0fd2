"""Model configuration (counterpart of ``repro/models/config.py``) with
torch dtypes.

The dataclass keeps the reference's field names for every arch the
reference registers: the dense attention archs (RoPE, partial RoPE,
M-RoPE, sinusoidal or no positions, qk-norm, RMS or LayerNorm, SwiGLU or
GELU MLP, the patch and audio-frame embedding frontends), the pure
Mamba-1 stacks, MoE (shared + routed top-k experts with capacity,
``models/moe.py``) in every layer or every k-th one, and the hybrid
Mamba + attention interleave (jamba). A non-uniform stack repeats a unit
of :attr:`ModelConfig.period` layers.
"""
from __future__ import annotations

import dataclasses
import math
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
    qk_norm: bool = False           # RMS norm of q and k over head_dim
    qkv_bias: bool = False
    # rope | rope_partial | mrope | sinusoidal | none (NoPE: jamba)
    pos_mode: str = "rope"
    rope_theta: float = 10000.0
    rotary_dim: int = 0             # for rope_partial (ChatGLM 2d-RoPE)
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    attn_chunk: int | None = None   # online-softmax KV chunk (None = dense)
    # --- mlp ---
    mlp_kind: str = "swiglu"        # swiglu | gelu (plain 2-matrix MLP)
    norm_kind: str = "rms"          # rms | layer
    # --- MoE ---
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    shared_d_ff: int = 0            # shared-expert hidden (qwen2-moe: 5632)
    moe_d_ff: int = 0               # routed-expert hidden
    moe_period: int = 1             # MoE FFN every k-th layer (jamba: 2)
    capacity_factor: float = 1.25
    # >1: the sequence folds into this many dispatch groups (the
    # reference's chunk-local dispatch); 0/1 = one group per batch row.
    moe_seq_chunks: int = 0
    renorm_topk: bool = True        # renormalize the top-k gate weights
    router_aux_coef: float = 0.0    # load-balance aux loss coefficient
    # --- SSM (Mamba-1) ---
    ssm: bool = False
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0                # 0 → ceil(d_model / 16)
    ssm_chunk: int = 256            # the reference's assoc scan chunk
    # The reference's XLA lowering of the scan ("fused_chunk" | "assoc");
    # both compute one recurrence, which the port runs as K9 either way.
    ssm_impl: str = "fused_chunk"
    ssm_unroll: int = 16            # the reference's fused_chunk unroll
    # --- hybrid interleave (jamba: attention every 8th layer, index 4) ---
    attn_period: int = 0            # 0 = not hybrid
    attn_index: int = 4
    # --- misc ---
    norm_eps: float = 1e-5
    # None | "patches" | "audio_tokens": stubs whose precomputed
    # embeddings [B, S, d_model] ``forward(embeds=...)`` takes
    frontend: str | None = None
    dtype: Any = torch.bfloat16
    # remat: "none" | "layer" (training recomputes each layer's internals
    # in the backward and keeps only the layer boundaries and the norms)
    remat: str = "layer"

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.dt_rank == 0 and self.ssm:
            object.__setattr__(self, "dt_rank", -(-self.d_model // 16))
        if self.moe and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_kinds(self) -> list[str]:
        """Sequence-mixer kind per layer: 'attn' or 'mamba'."""
        if self.ssm and not self.attn_period:
            return ["mamba"] * self.num_layers
        if self.attn_period:
            return ["attn" if i % self.attn_period == self.attn_index
                    else "mamba" for i in range(self.num_layers)]
        return ["attn"] * self.num_layers

    def ffn_kinds(self) -> list[str]:
        """FFN kind per layer: 'moe' | 'mlp' | 'none'."""
        out = []
        for i in range(self.num_layers):
            if self.moe and i % self.moe_period == self.moe_period - 1:
                out.append("moe")
            elif self.d_ff > 0:
                out.append("mlp")
            else:
                out.append("none")
        return out

    @property
    def is_uniform(self) -> bool:
        """True when every layer is identical (a unit of one layer)."""
        return (len(set(self.layer_kinds())) == 1
                and len(set(self.ffn_kinds())) == 1)

    @property
    def pattern_len(self) -> int:
        """lcm(attn_period or 1, moe_period of an MoE stack): the layers
        after which the kinds repeat."""
        return math.lcm(self.attn_period or 1,
                        self.moe_period if self.moe else 1)

    @property
    def period(self) -> int:
        """Length of the repeating layer pattern (the stacked unit): 1 for
        a uniform stack, else :attr:`pattern_len`."""
        if self.is_uniform:
            return 1
        p = self.pattern_len
        assert self.num_layers % p == 0, (self.num_layers, p)
        return p

    def count_params(self) -> int:
        """Total parameter count (embeddings + head included), as the
        reference counts it."""
        D, V = self.d_model, self.vocab_size
        total = 2 * V * D + D  # embed + head + final norm
        for lk, fk in zip(self.layer_kinds(), self.ffn_kinds()):
            total += D  # ln1
            if lk == "attn":
                total += (self.q_dim * D + 2 * self.kv_dim * D
                          + D * self.q_dim)
                if self.qkv_bias:
                    total += self.q_dim + 2 * self.kv_dim
                if self.qk_norm:
                    total += 2 * self.head_dim
            else:
                di, n, dtr = self.d_inner, self.ssm_state, self.dt_rank
                total += (2 * di * D + di * self.ssm_conv + di
                          + (dtr + 2 * n) * di + di * dtr + di
                          + di * n + di + D * di)
            if fk != "none":
                total += D  # ln2
            if fk == "mlp":
                total += (3 if self.mlp_kind == "swiglu" else 2) \
                    * self.d_ff * D
            elif fk == "moe":
                total += self.num_experts * (3 * self.moe_d_ff * D) \
                    + self.num_experts * D
                if self.num_shared_experts:
                    total += 3 * self.shared_d_ff * D + D
        return total

    @property
    def n_scan(self) -> int:
        return self.num_layers // self.period


POS_MODES = ("rope", "rope_partial", "mrope", "sinusoidal", "none")
FRONTENDS = (None, "patches", "audio_tokens")


def check_supported(mcfg: ModelConfig) -> None:
    """Raise ValueError for values no package knows, and for a stack
    whose depth is no whole number of its repeating units (where the
    reference's ``period`` asserts)."""
    if not mcfg.is_uniform and mcfg.num_layers % mcfg.pattern_len:
        kind = ("hybrid" if mcfg.attn_period
                else f"MoE-every-{mcfg.moe_period}")
        raise ValueError(
            f"{mcfg.name}: a {kind} stack of {mcfg.num_layers} layers is "
            f"no whole number of its {mcfg.pattern_len}-layer units")
    if mcfg.moe and not (0 < mcfg.top_k <= mcfg.num_experts):
        raise ValueError(f"{mcfg.name}: MoE needs 0 < top_k <= num_experts, "
                         f"got top_k {mcfg.top_k} of {mcfg.num_experts}")
    if mcfg.ssm and mcfg.ssm_impl not in ("fused_chunk", "assoc"):
        raise ValueError(f"{mcfg.name}: unknown ssm_impl {mcfg.ssm_impl!r} "
                         f"(expected 'fused_chunk' or 'assoc')")
    if mcfg.remat not in ("none", "layer"):
        raise ValueError(f"{mcfg.name}: unknown remat {mcfg.remat!r} "
                         f"(expected 'none' or 'layer')")
    for field, known in (("pos_mode", POS_MODES), ("frontend", FRONTENDS),
                         ("mlp_kind", ("swiglu", "gelu")),
                         ("norm_kind", ("rms", "layer"))):
        if getattr(mcfg, field) not in known:
            raise ValueError(f"{mcfg.name}: unknown {field} "
                             f"{getattr(mcfg, field)!r} (expected one of "
                             f"{known})")
    if mcfg.pos_mode == "rope_partial" and not (
            0 < mcfg.rotary_dim <= mcfg.head_dim
            and mcfg.rotary_dim % 2 == 0):
        raise ValueError(f"{mcfg.name}: rope_partial needs an even "
                         f"rotary_dim in (0, head_dim], got "
                         f"{mcfg.rotary_dim}")
    if mcfg.pos_mode == "mrope" and sum(mcfg.mrope_sections) \
            != mcfg.head_dim // 2:
        raise ValueError(f"{mcfg.name}: mrope_sections "
                         f"{mcfg.mrope_sections} must sum to head_dim // 2 "
                         f"= {mcfg.head_dim // 2}")
