"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60e top-4 + shared expert (4×1408 = 5632 hidden).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
Same numbers as ``repro/configs/qwen2_moe_a2_7b.py``: QKV bias, top-4 of
60 routed experts with raw softmax gate weights (``renorm_topk=False``),
one shared expert of hidden 5632 scaled by a sigmoid gate."""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=151936,
    qkv_bias=True, rope_theta=1e6,
    moe=True, num_experts=60, top_k=4, moe_d_ff=1408,
    num_shared_experts=4, shared_d_ff=5632, renorm_topk=False,
    attn_chunk=1024,
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=32, vocab_size=256,
    qkv_bias=True,
    moe=True, num_experts=8, top_k=4, moe_d_ff=32,
    num_shared_experts=4, shared_d_ff=128, renorm_topk=False,
    capacity_factor=8.0,
    dtype=torch.float32,
)
