"""Factored row-wise norm (paper §2, Algorithm 1); counterpart of
``repro/core/factored_norm.py``.

    ||W + s*B*A||^2_row = ||W||^2_row + 2s*<W, BA>_row + s^2*||BA||^2_row

    cross_j = rowsum(B ⊙ U)_j,        U = W @ Aᵀ   [d_out, r]
    ba_j    = rowsum((B @ G) ⊙ B)_j,  G = A @ Aᵀ   [r, r]

All accumulation is fp32; the result is detached (DoRA §4.3). This module
is the eager (Tier-3) implementation plus the two baselines and the fp64
oracle.
"""
from __future__ import annotations

import torch

from repro_torch.core.compose import f32

_F32 = torch.float32


def dtype_eps(dtype) -> float:
    """Dtype-aware epsilon for the magnitude division (paper App. B)."""
    if dtype in (torch.bfloat16, torch.float16):
        return 1e-6
    return 1e-12


def chunk_size(d_out: int, d_in: int, budget_mb: int | None) -> int:
    """cs = min(d_in, floor(budget / (d_out * 4))), aligned to 64 (Alg. 1)."""
    if budget_mb is None:
        return d_in
    cs = max(1, (budget_mb * (1 << 20)) // (d_out * 4))
    cs = min(d_in, cs)
    if cs >= 64:
        cs = (cs // 64) * 64
    return cs


@torch.no_grad()
def factored_norm_terms(W, A, B, *, chunk_mb: int | None = None,
                        compute_cross: bool = True):
    """Return (base_sq, cross, ba_sq), all fp32 [d_out].

    ``compute_cross=False`` is the s=0 fast path (paper App. B)."""
    d_out, d_in = W.shape
    if not compute_cross:
        zeros = torch.zeros(d_out, dtype=_F32, device=W.device)
        if chunk_mb is None:
            w32 = W.to(_F32)
            return (w32 * w32).sum(dim=1), zeros, zeros
        base_sq = torch.zeros(d_out, dtype=_F32, device=W.device)
        cs = chunk_size(d_out, d_in, chunk_mb)
        for c in range(0, d_in, cs):
            wc = W[:, c:c + cs].to(_F32)
            base_sq = base_sq + (wc * wc).sum(dim=1)
        return base_sq, zeros, zeros

    r = A.shape[0]
    B32 = B.to(_F32)
    cs = chunk_size(d_out, d_in, chunk_mb)
    if cs >= d_in:
        W32 = W.to(_F32)
        A32 = A.to(_F32)
        base_sq = (W32 * W32).sum(dim=1)
        G = A32 @ A32.T
        U = W32 @ A32.T
        cross = (B32 * U).sum(dim=1)
    else:
        base_sq = torch.zeros(d_out, dtype=_F32, device=W.device)
        cross = torch.zeros(d_out, dtype=_F32, device=W.device)
        G = torch.zeros(r, r, dtype=_F32, device=W.device)
        for c in range(0, d_in, cs):
            wc = W[:, c:c + cs].to(_F32)
            ac = A[:, c:c + cs].to(_F32)
            base_sq = base_sq + (wc * wc).sum(dim=1)
            G = G + ac @ ac.T
            cross = cross + (B32 * (wc @ ac.T)).sum(dim=1)
    ba_sq = ((B32 @ G) * B32).sum(dim=1)
    return base_sq, cross, ba_sq


def assemble_norm(base_sq, cross, ba_sq, s: float):
    """w_norm = sqrt(max(base + 2s*cross + s^2*ba, 0)) (paper Eq. 5). The
    scalars are formed in fp64 and rounded to fp32; ``torch.clamp_min``
    propagates NaNs (paper App. C)."""
    two_s, s2 = f32(2.0 * float(s)), f32(float(s) * float(s))
    wn2 = base_sq + two_s * cross + s2 * ba_sq
    return torch.sqrt(torch.clamp_min(wn2, 0.0))


@torch.no_grad()
def factored_norm(W, A, B, s: float, *, chunk_mb: int | None = None,
                  base_sq_cache=None):
    """Detached fp32 row-wise norm of W + s*B*A via the factored terms.
    ``base_sq_cache``: precomputed ||W||^2_row (paper §2.3 future work)."""
    if s == 0.0 and base_sq_cache is not None:
        return torch.sqrt(torch.clamp_min(base_sq_cache, 0.0))
    if base_sq_cache is not None:
        _, cross, ba_sq = factored_norm_terms(W, A, B, chunk_mb=chunk_mb)
        base_sq = base_sq_cache
    else:
        base_sq, cross, ba_sq = factored_norm_terms(
            W, A, B, chunk_mb=chunk_mb, compute_cross=(s != 0.0))
    return assemble_norm(base_sq, cross, ba_sq, s)


@torch.no_grad()
def norm_peft_eye(W, A, B, s: float):
    """HF PEFT's identity-matrix pattern (paper §1): materializes a
    [d_in, d_in] identity and the dense B@A product."""
    d_in = W.shape[1]
    x_eye = torch.eye(d_in, dtype=A.dtype, device=A.device)
    lora_weight = ((x_eye @ A.T) @ B.T).T
    composed = W.to(_F32) + float(s) * lora_weight.to(_F32)
    return torch.linalg.vector_norm(composed, dim=1)


@torch.no_grad()
def norm_dense_ba(W, A, B, s: float):
    """Direct dense product (paper §5.3 "Dense (B@A)")."""
    ba = B.to(_F32) @ A.to(_F32)
    composed = W.to(_F32) + float(s) * ba
    return torch.linalg.vector_norm(composed, dim=1)


@torch.no_grad()
def norm_reference_fp64(W, A, B, s: float):
    """fp64 oracle for tests."""
    W64 = W.to(torch.float64)
    ba = B.to(torch.float64) @ A.to(torch.float64)
    return torch.sqrt(((W64 + float(s) * ba) ** 2).sum(dim=1))
