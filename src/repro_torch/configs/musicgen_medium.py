"""musicgen-medium [audio] — 48L d_model=1536 24H (kv=24, MHA) d_ff=6144
vocab=2048, decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]
Same numbers as ``repro/configs/musicgen_medium.py``.

A plain transformer decoder: LayerNorm, GELU MLP (no gating), sinusoidal
absolute positions. The EnCodec frontend is a stub: ``forward(embeds=...)``
takes precomputed frame embeddings (the sum of the 4 codebook embeddings
at each frame)."""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    pos_mode="sinusoidal", mlp_kind="gelu", norm_kind="layer",
    attn_chunk=1024, frontend="audio_tokens",
)

SMOKE = ModelConfig(
    name="musicgen-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=64,
    pos_mode="sinusoidal", mlp_kind="gelu", norm_kind="layer",
    frontend="audio_tokens",
    dtype=torch.float32,
)
