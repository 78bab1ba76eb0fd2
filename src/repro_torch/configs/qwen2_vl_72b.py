"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, M-RoPE + dynamic resolution. [arXiv:2409.12191; hf]
Same numbers as ``repro/configs/qwen2_vl_72b.py``.

The vision frontend is a stub: ``forward(embeds=...)`` takes precomputed
patch embeddings [B, S, d_model]; the backbone is the transformer with
M-RoPE (sections 16/24/24 over the 64 rotary pairs)."""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064,
    qkv_bias=True, pos_mode="mrope", mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    attn_chunk=1024, frontend="patches",
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256,
    qkv_bias=True, pos_mode="mrope", mrope_sections=(2, 3, 3),
    frontend="patches",
    dtype=torch.float32,
)
