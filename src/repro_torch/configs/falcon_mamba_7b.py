"""falcon-mamba-7b [ssm] — 64L d_model=4096, attention-free Mamba-1,
ssm_state=16, vocab=65024. [arXiv:2410.05355]
Same numbers as ``repro/configs/falcon_mamba_7b.py``.

Pure Mamba-1 stack: each layer is norm → mamba → residual (no MLP
sublayer, d_ff = 0). d_inner = 2 × 4096 = 8192, dt_rank = 256.
"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=65024,
    ssm=True, ssm_state=16, ssm_conv=4, ssm_expand=2,
)

SMOKE = ModelConfig(
    name="falcon-mamba-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=256,
    ssm=True, ssm_state=4, ssm_conv=4, ssm_expand=2, ssm_chunk=32,
    dtype=torch.float32,
)
