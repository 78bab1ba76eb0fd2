"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064, RoPE + SwiGLU + GQA. [arXiv:2412.08905; hf]
Same numbers as ``repro/configs/phi4_mini_3_8b.py``."""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=200064,
    attn_chunk=1024,
)

SMOKE = ModelConfig(
    name="phi4-mini-smoke", family="dense",
    num_layers=2, d_model=48, num_heads=3, num_kv_heads=1,
    d_ff=128, vocab_size=256,
    dtype=torch.float32,
)
