"""DoRA composition in the numerically stable form (paper §3.1);
counterpart of ``repro/core/compose.py``.

    delta = (g - 1) ⊙ base + g ⊙ s ⊙ lora,      g = m / max(w_norm, eps)

Canonical evaluation order: ``s * lora`` first, then ``g·(·)``, with fp32
intermediates and the output in the input dtype.
"""
from __future__ import annotations

import numpy as np
import torch

_F32 = torch.float32


def f32(x: float) -> float:
    """``x`` rounded to fp32. A product of an fp32 tensor with this scalar
    is the fp32 product whether the backend multiplies in fp32 or fp64
    (both round the exact product once), matching the reference's
    ``jnp.asarray(s, float32) * x``."""
    return float(np.float32(x))


def magnitude_scale(m, w_norm, eps: float):
    """g = m / max(w_norm, eps), fp32 (paper Eq. 6)."""
    return m.to(_F32) / torch.clamp_min(w_norm.to(_F32), eps)


def check_broadcast(g, base):
    """g must broadcast exclusively along the last dim of the activation
    (paper App. B)."""
    if g.ndim != 1 or base.shape[-1] != g.shape[0]:
        raise ValueError(
            f"magnitude scale of shape {tuple(g.shape)} does not broadcast "
            f"along the last dim of activations with shape "
            f"{tuple(base.shape)}; this shape routes to the eager fallback "
            f"in the paper and is unsupported here")


def compose_stable(base, lora, g, s: float):
    """Eager (Tier-3) stable compose; fp32 intermediates, input-dtype
    output."""
    check_broadcast(g, base)
    g32 = g.to(_F32)
    t = f32(s) * lora.to(_F32)                    # s*lora first
    delta = (g32 - 1.0) * base.to(_F32) + g32 * t
    return delta.to(base.dtype)


def compose_naive(base, lora, g, s: float):
    """The cancellation-prone form, g·(s·lora + base) − base, evaluated in
    the input dtype (``repro/core/compose.py:52``): only the stability
    comparison (paper Fig. 1) uses it; never dispatched."""
    dt = base.dtype
    inner = torch.tensor(s, dtype=dt, device=base.device) * lora + base
    return g.to(dt) * inner - base


def compose_reference_fp64(base, lora, g, s: float):
    """fp64 oracle for stability tests (paper Fig. 1 reference)."""
    b = base.to(torch.float64)
    lo = lora.to(torch.float64)
    g64 = g.to(torch.float64)
    return (g64 - 1.0) * b + g64 * (float(s) * lo)


def select_tenant(all_k, idx):
    """Exact per-row tenant select for the dynamic grouped compose
    (:func:`repro_torch.core.adapter.dora_linear_grouped`).

    ``all_k`` is an all-tenant intermediate ``[B, S, K, ...]``: every row's
    contribution computed for every stacked tenant ``k`` by one batched
    contraction whose reduction order does not depend on the tenant. ``idx``
    is the per-row int tenant index ``[B]``. The select is a pure gather on
    the K axis, so row ``b``'s result is the very value computed for tenant
    ``idx[b]``: no arithmetic touches it."""
    b = all_k.shape[0]
    if tuple(idx.shape) != (b,):
        raise ValueError(
            f"per-row tenant index has shape {tuple(idx.shape)}; need "
            f"({b},) — one stacked-tenant position per batch row")
    ix = idx.to(device=all_k.device, dtype=torch.int64).reshape(
        (b,) + (1,) * (all_k.ndim - 1))
    return torch.take_along_dim(all_k, ix, dim=2).squeeze(2)
