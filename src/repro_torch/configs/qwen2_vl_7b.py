"""qwen2-vl-7b [vlm] — the paper's primary evaluation backbone (Qwen2-VL
family). 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064, M-RoPE
with sections (16, 24, 24), QKV bias. Same numbers as
``repro/configs/qwen2_vl_7b.py``.

The vision frontend is a stub: ``forward(embeds=...)`` takes precomputed
patch embeddings [B, S, d_model]."""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    qkv_bias=True, pos_mode="mrope", mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    attn_chunk=1024, frontend="patches",
)

SMOKE = ModelConfig(
    name="qwen2-vl-7b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256,
    qkv_bias=True, pos_mode="mrope", mrope_sections=(2, 3, 3),
    frontend="patches",
    dtype=torch.float32,
)
