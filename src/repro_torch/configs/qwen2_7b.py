"""qwen2-7b [dense] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, GQA with QKV bias. [arXiv:2407.10671; hf]
Same numbers as ``repro/configs/qwen2_7b.py``."""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6,
    attn_chunk=1024,
)

SMOKE = ModelConfig(
    name="qwen2-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256,
    qkv_bias=True,
    dtype=torch.float32,
)
