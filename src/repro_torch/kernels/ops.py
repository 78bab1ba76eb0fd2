"""Wrappers the adapter calls around the kernels (counterpart of
``repro/kernels/ops.py``), forward only.

  - :func:`fused_norm`: K1 (terms) + the Gram term in plain matmuls + K2
    (assembly); detached.
  - :func:`fused_compose`: K3 on a materialized y_lora.
  - :func:`fused_compose_mm`: K6 on the factored h = x·Aᵀ.

The kernels mask their ragged edges, so nothing is padded here. The
compose backward kernels come with the training slice of the port; until
then the compose wrappers refuse inputs that would need a gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dora_compose import compose_fwd, compose_mm_fwd
from repro_torch.kernels.factored_norm import norm_terms
from repro_torch.kernels.norm_assembly import assemble_norm

_F32 = torch.float32


def _refuse_grad(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is forward-only: its backward kernels come with the "
            f"training slice of the port. Run it under torch.no_grad() or "
            f"on tensors that do not require grad.")


def _gm1(g, n: int):
    return (g.to(_F32) - 1.0).reshape(n).contiguous()


def fused_compose(base, lora, g, s: float):
    """delta = (g-1)⊙base + g⊙s⊙lora through K3. base, lora [..., d_out];
    g fp32 [d_out]."""
    _refuse_grad("fused_compose", base, lora, g)
    shape = base.shape
    n = shape[-1]
    delta = compose_fwd(base.reshape(-1, n).contiguous(),
                        lora.reshape(-1, n).contiguous(), _gm1(g, n), s)
    return delta.reshape(shape)


def fused_compose_mm(base, h, B, g, s: float):
    """delta = (g-1)⊙base + g⊙s⊙(h·Bᵀ) through K6. base [..., d_out],
    h = x·Aᵀ [..., r], B [d_out, r], g fp32 [d_out]."""
    if base.shape[:-1] != h.shape[:-1]:
        raise ValueError(f"base leading dims {tuple(base.shape[:-1])} != "
                         f"h leading dims {tuple(h.shape[:-1])}")
    _refuse_grad("fused_compose_mm", base, h, B, g)
    shape = base.shape
    n = shape[-1]
    delta = compose_mm_fwd(base.reshape(-1, n).contiguous(),
                           h.reshape(-1, h.shape[-1]).contiguous(),
                           B.contiguous(), _gm1(g, n), s)
    return delta.reshape(shape)


@torch.no_grad()
def fused_norm(W, A, B, s: float, *, base_sq_cache=None):
    """Detached fp32 row-wise norm of W + s·B·A through K1 and K2."""
    if s == 0.0:
        if base_sq_cache is not None:
            return torch.sqrt(torch.clamp_min(base_sq_cache, 0.0))
        w32 = W.to(_F32)
        return torch.sqrt(torch.clamp_min((w32 * w32).sum(dim=1), 0.0))
    base_sq, cross = norm_terms(W.contiguous(), A.contiguous(),
                                B.contiguous())
    if base_sq_cache is not None:
        base_sq = base_sq_cache.to(_F32).contiguous()
    A32 = A.to(_F32)
    B32 = B.to(_F32)
    G = A32 @ A32.T                                   # [r, r]
    ba_sq = ((B32 @ G) * B32).sum(dim=1)
    return assemble_norm(base_sq, cross, ba_sq, s)
