"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE of 16
experts top-2 every other layer. 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=65536, ssm_state=16. [arXiv:2403.19887; hf]
Same numbers as ``repro/configs/jamba_v0_1_52b.py``.

The attention layers run with no positional encoding (NoPE, ``pos_mode=
"none"``): the Mamba layers carry position. The MoE hidden dim equals the
dense MLP's. Period = lcm(attn_period 8, moe_period 2) = 8: one attention
layer at index 4 of every 8, the MoE FFN on odd indices, a dense SwiGLU
MLP on even ones.
"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    pos_mode="none",
    moe=True, num_experts=16, top_k=2, moe_d_ff=14336, moe_period=2,
    ssm=True, ssm_state=16, ssm_conv=4, ssm_expand=2,
    attn_period=8, attn_index=4,
    attn_chunk=1024,
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256,
    pos_mode="none",
    moe=True, num_experts=4, top_k=2, moe_d_ff=128, moe_period=2,
    capacity_factor=8.0,
    ssm=True, ssm_state=4, ssm_conv=4, ssm_expand=2, ssm_chunk=32,
    attn_period=8, attn_index=4,
    dtype=torch.float32,
)
