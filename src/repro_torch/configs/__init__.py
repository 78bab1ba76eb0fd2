"""Architecture registry of the port: each arch has a FULL config (the
published numbers) and a SMOKE config (reduced, runs on CPU). The
reference registers more archs; the port runs the dense qwen2-7b and the
pure Mamba-1 falcon-mamba-7b."""
from __future__ import annotations

import importlib

_MODULES = {"qwen2-7b": "qwen2_7b", "falcon-mamba-7b": "falcon_mamba_7b"}

# Archs the reference registers that later slices port.
NOT_PORTED = ("jamba-v0.1-52b", "qwen2-moe-a2.7b", "llama4-scout-17b-a16e",
              "chatglm3-6b", "phi4-mini-3.8b",
              "qwen3-32b", "qwen2-vl-72b", "musicgen-medium", "qwen2-vl-7b")


def get_config(arch: str, smoke: bool = False):
    if arch in NOT_PORTED:
        raise NotImplementedError(f"arch {arch!r} is not ported yet; "
                                  f"ported: {sorted(_MODULES)}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["get_config", "NOT_PORTED"]
