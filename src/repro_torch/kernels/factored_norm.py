"""K1: fused factored-norm terms (paper §2, Algorithm 1).

Replaces ``repro/kernels/factored_norm.py:49 norm_terms_pallas``. For W
[d_out, d_in], A [r, d_in], B [d_out, r] it returns fp32 [d_out]

    base_sq_j = Σ_k W_jk²,    cross_j = Σ_l B_jl·(W·Aᵀ)_jl

in one pass over W (kernel: ``csrc/norm_terms.cu``). bf16 operands run on
the tensor cores with d_in split across blocks (:func:`norm_terms_split`)
and the partials summed in a fixed order; fp32 and fp16 run the FMA
kernel. CUDA tensors launch the kernel or raise; CPU tensors run
:func:`norm_terms_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_F32 = torch.float32

# The tensor-core kernel's block tile (csrc/norm_terms.cu, namespace k1):
# rows of d_out, rank columns, and the depth of one staged k-tile.
TILE_ROWS, TILE_RANK, TILE_K = 128, 192, 64


def norm_terms_split(d_out: int, d_in: int, r: int) -> tuple[int, int]:
    """(splits, split_k) of d_in for the tensor-core kernel."""
    tiles = _build.cdiv(d_out, TILE_ROWS) * _build.cdiv(r, TILE_RANK)
    return _build.split_plan(tiles, d_in, TILE_K)


def norm_terms_plain(W, A, B):
    """Plain PyTorch version of the kernel's function."""
    W32 = W.to(_F32)
    U = W32 @ A.to(_F32).T
    return (W32 * W32).sum(dim=1), (B.to(_F32) * U).sum(dim=1)


@_build.no_grad
def norm_terms(W, A, B):
    """(base_sq, cross) fp32 [d_out] for W [d_out, d_in], A [r, d_in],
    B [d_out, r], all of one dtype (fp32, bf16 or fp16)."""
    if W.ndim != 2 or A.ndim != 2 or B.ndim != 2:
        raise ValueError("norm_terms takes 2-D W, A, B")
    d_out, d_in = W.shape
    r = A.shape[0]
    if A.shape[1] != d_in or tuple(B.shape) != (d_out, r):
        raise ValueError(f"norm_terms: shapes W {tuple(W.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)} do not "
                         f"agree (want A [r, d_in], B [d_out, r])")
    if W.device.type == "cpu":
        return norm_terms_plain(W, A, B)
    _build.check_operands("norm_terms", W, A, B, dtype=W.dtype)
    code = _build.dtype_code("norm_terms", W)
    base_sq = torch.empty(d_out, dtype=_F32, device=W.device)
    cross = torch.empty(d_out, dtype=_F32, device=W.device)
    if d_out == 0:
        return base_sq, cross
    split_k, scratch = 0, None
    if _build.tensor_cores(W, A, dims=(d_in,)) and d_in > 0 and r > 0:
        splits, split_k = norm_terms_split(d_out, d_in, r)
        rank_tiles = _build.cdiv(r, TILE_RANK)
        scratch = torch.empty(splits * (1 + rank_tiles) * d_out, dtype=_F32,
                              device=W.device)
    rc = _build.library().norm_terms(
        W.data_ptr(), A.data_ptr(), B.data_ptr(), base_sq.data_ptr(),
        cross.data_ptr(), None if scratch is None else scratch.data_ptr(),
        d_out, d_in, r, split_k, code, _build.stream_of(W))
    _build.check(rc, "norm_terms")
    norm_terms.launches += 1
    return base_sq, cross


norm_terms.launches = 0
