"""Core DoRA library of the port (counterpart of ``repro/core``): the
names ``repro/core/__init__.py`` exports, resolved on first use.

The exports are looked up lazily (PEP 562) because ``core.adapter``
imports the kernel wrappers, which import ``core.compose``: an eager
import here would close that cycle whenever a kernel module is imported
first.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "config": ("DoRAConfig",),
    "adapter": ("dora_linear", "dora_linear_grouped",
                "dora_linear_stacked", "init_dora_params",
                "compute_weight_norm", "compose_delta",
                "compose_delta_factored", "precompute_adapter_state",
                "invalidate_adapter_state", "stack_adapter_states"),
    "adapter_cache": ("AdapterCacheMiss", "AdapterHandle", "AdapterKey",
                      "AdapterStateCache", "CacheStats"),
    "factored_norm": ("factored_norm_terms", "assemble_norm",
                      "factored_norm_sharded", "norm_peft_eye",
                      "norm_dense_ba", "dtype_eps"),
    "compose": ("compose_stable", "compose_naive", "magnitude_scale",
                "select_tenant"),
    "dispatch": ("Tier", "select_tier"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_WHERE)


def __getattr__(name: str):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_WHERE[name]}"),
                    name)
    globals()[name] = value
    return value
