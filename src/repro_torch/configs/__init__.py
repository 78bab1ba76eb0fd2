"""Architecture registry of the port: each arch has a FULL config (the
published numbers) and a SMOKE config (reduced, runs on CPU). The
port runs every arch the reference registers: the dense ones (qwen2-7b,
phi4-mini-3.8b, chatglm3-6b, qwen3-32b, the paper's qwen2-vl-7b,
qwen2-vl-72b and musicgen-medium, whose frontends are stubs that take
precomputed embeddings), the pure Mamba-1 falcon-mamba-7b, the MoE
qwen2-moe-a2.7b and llama4-scout-17b-a16e, and the hybrid
jamba-v0.1-52b."""
from __future__ import annotations

import importlib

_MODULES = {"qwen2-7b": "qwen2_7b", "falcon-mamba-7b": "falcon_mamba_7b",
            "phi4-mini-3.8b": "phi4_mini_3_8b", "qwen2-vl-7b": "qwen2_vl_7b",
            "chatglm3-6b": "chatglm3_6b", "qwen3-32b": "qwen3_32b",
            "musicgen-medium": "musicgen_medium",
            "qwen2-vl-72b": "qwen2_vl_72b",
            "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
            "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
            "jamba-v0.1-52b": "jamba_v0_1_52b"}

# Archs the reference registers that the port does not run: none left.
NOT_PORTED = ()


def get_config(arch: str, smoke: bool = False):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["get_config", "NOT_PORTED"]
