"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
Same numbers as ``repro/configs/llama4_scout_17b_a16e.py``: 16 routed
experts, top-1 routing, MoE in every layer, no shared expert."""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    rope_theta=5e5,
    moe=True, num_experts=16, top_k=1, moe_d_ff=8192,
    attn_chunk=1024,
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256,
    moe=True, num_experts=4, top_k=1, moe_d_ff=128,
    capacity_factor=8.0,
    dtype=torch.float32,
)
