"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, qk_norm, decoupled head_dim=128 (q_dim 8192 != d_model).
[hf:Qwen/Qwen3-8B; hf] Same numbers as ``repro/configs/qwen3_32b.py``."""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
    d_ff=25600, vocab_size=151936,
    head_dim=128, qk_norm=True, rope_theta=1e6,
    attn_chunk=1024,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256,
    head_dim=32, qk_norm=True,
    dtype=torch.float32,
)
