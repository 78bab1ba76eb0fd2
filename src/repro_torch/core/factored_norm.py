"""Factored row-wise norm (paper §2, Algorithm 1); counterpart of
``repro/core/factored_norm.py``.

    ||W + s*B*A||^2_row = ||W||^2_row + 2s*<W, BA>_row + s^2*||BA||^2_row

    cross_j = rowsum(B ⊙ U)_j,        U = W @ Aᵀ   [d_out, r]
    ba_j    = rowsum((B @ G) ⊙ B)_j,  G = A @ Aᵀ   [r, r]

All accumulation is fp32; the result is detached (DoRA §4.3). This module
is the eager (Tier-3) implementation, the sharded variant (W and A split
along d_in over mesh axes: three small sums replace a gather of the
weight, the paper's §6 future work) and the two baselines and the fp64
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
def factored_norm_sharded(W, A, B, s: float, *, axis_name, mesh,
                          chunk_mb: int | None = None, base_sq_cache=None,
                          kernels: bool = False):
    """Factored norm with W [d_out, d_in_l] and A [r, d_in_l] this rank's
    d_in shard along ``axis_name`` of ``mesh`` (counterpart of
    ``repro/core/factored_norm.py:130``): each rank takes its partials of
    base_sq and cross and its G_l = A_l·A_lᵀ, and three sums over the
    axis ([d_out], [d_out], [r, r], in the reference's order) replace a
    gather of the weight; B and the result are whole on every rank.

    ``kernels``: the partials come from K1 without its epilogue
    (``kernels.factored_norm.norm_terms``) and the assembly is the
    standalone K2 (``kernels.norm_assembly.assemble_norm``), each
    running its plain version on CPU tensors; else the eager terms.
    ``base_sq_cache``: the already summed ||W||²_row; with it base_sq is
    not summed, and the eager terms take no W² pass (K1 reads W for the
    cross term and forms its base_sq partial from the same tiles, which
    is then dropped). ``chunk_mb`` is taken for the reference's
    signature: like the reference, only the s = 0 pass chunks."""
    from repro_torch.core.sharding import psum
    from repro_torch.kernels import factored_norm as _k1
    from repro_torch.kernels import norm_assembly as _k2

    tag = "norm"
    if s == 0.0:
        if base_sq_cache is not None:
            return torch.sqrt(torch.clamp_min(base_sq_cache, 0.0))
        base_l, _, _ = factored_norm_terms(W, A, B, chunk_mb=chunk_mb,
                                           compute_cross=False)
        base_sq = psum(base_l, axis_name, mesh, tag=tag)
        return torch.sqrt(torch.clamp_min(base_sq, 0.0))
    A32 = A.to(_F32)
    B32 = B.to(_F32)
    if kernels:
        base_l, cross_l = _k1.norm_terms(W.contiguous(), A.contiguous(),
                                         B.contiguous())
    else:
        W32 = W.to(_F32)
        if base_sq_cache is None:
            base_l = (W32 * W32).sum(dim=1)
        cross_l = (B32 * (W32 @ A32.T)).sum(dim=1)
    G_l = A32 @ A32.T
    # rowsum(B ⊙ ΣU_s) = Σ rowsum(B ⊙ U_s): cross partials sum linearly.
    if base_sq_cache is not None:
        base_sq = base_sq_cache.to(_F32)
    else:
        base_sq = psum(base_l, axis_name, mesh, tag=tag)
    cross = psum(cross_l, axis_name, mesh, tag=tag)
    G = psum(G_l, axis_name, mesh, tag=tag)
    ba_sq = ((B32 @ G) * B32).sum(dim=1)
    if kernels:
        return _k2.assemble_norm(base_sq.contiguous(), cross.contiguous(),
                                 ba_sq.contiguous(), s)
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
