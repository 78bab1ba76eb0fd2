"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024, 2d-RoPE (partial rotary: half the head dim), QKV bias.
[arXiv:2406.12793; hf] Same numbers as ``repro/configs/chatglm3_6b.py``."""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=65024,
    qkv_bias=True, pos_mode="rope_partial", rotary_dim=64,
    attn_chunk=1024,
)

SMOKE = ModelConfig(
    name="chatglm3-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256,
    qkv_bias=True, pos_mode="rope_partial", rotary_dim=8,
    dtype=torch.float32,
)
