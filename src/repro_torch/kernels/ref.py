"""Dense oracles for the kernels (counterpart of ``repro/kernels/ref.py``).

Independent of the kernels and of their plain versions: no factored
algebra, no chunking, no tiling.
"""
from __future__ import annotations

import torch

from repro_torch.core.compose import f32

_F32 = torch.float32
_F64 = torch.float64


def ref_norm_terms(W, A, B):
    """Dense (base_sq, cross) fp32 [d_out]."""
    W32 = W.to(_F32)
    BA = B.to(_F32) @ A.to(_F32)
    return (W32 * W32).sum(dim=1), (W32 * BA).sum(dim=1)


def ref_norm(W, A, B, s: float):
    """Dense fp32 row-wise norm of W + s·B·A."""
    BA = B.to(_F32) @ A.to(_F32)
    return torch.linalg.vector_norm(W.to(_F32) + f32(s) * BA, dim=1)


def ref_norm_fp64(W, A, B, s: float):
    BA = B.to(_F64) @ A.to(_F64)
    return torch.linalg.vector_norm(W.to(_F64) + float(s) * BA, dim=1)


def ref_assemble(base_sq, cross, ba_sq, s: float):
    s = float(s)
    return torch.sqrt(torch.clamp_min(
        base_sq.to(_F32) + f32(2.0 * s) * cross.to(_F32)
        + f32(s * s) * ba_sq.to(_F32), 0.0))


def ref_assemble_fp64(base_sq, cross, ba_sq, s: float):
    s = float(s)
    return torch.sqrt(torch.clamp_min(
        base_sq.to(_F64) + 2.0 * s * cross.to(_F64)
        + s * s * ba_sq.to(_F64), 0.0))


def ref_compose(base, lora, g, s: float):
    """Stable compose, fp32 intermediates, input-dtype output."""
    g32 = g.to(_F32)
    t = f32(s) * lora.to(_F32)
    return ((g32 - 1.0) * base.to(_F32) + g32 * t).to(base.dtype)


def ref_compose_fp64(base, lora, g, s: float):
    g64 = g.to(_F64)
    return (g64 - 1.0) * base.to(_F64) + g64 * (float(s) * lora.to(_F64))


def ref_compose_mm(base, h, B, g, s: float):
    """The lora product materialized densely in fp32, then the stable
    compose: what the matmul-fused kernel must match."""
    lora = h.to(_F32) @ B.to(_F32).T
    return ref_compose(base, lora, g, s)


def ref_compose_mm_fp64(base, h, B, g, s: float):
    lora = h.to(_F64) @ B.to(_F64).T
    return ref_compose_fp64(base, lora, g, s)
