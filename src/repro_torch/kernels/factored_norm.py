"""K1: fused factored-norm terms (paper §2, Algorithm 1), and the norm
assembly (K2's function) as K1's epilogue.

Replaces ``repro/kernels/factored_norm.py:49 norm_terms_pallas``. For W
[d_out, d_in], A [r, d_in], B [d_out, r] it returns fp32 [d_out]

    base_sq_j = Σ_k W_jk²,    cross_j = Σ_l B_jl·(W·Aᵀ)_jl

in one pass over W (kernel: ``csrc/norm_terms.cu``). bf16 operands run on
the tensor cores with d_in split across blocks (:func:`norm_terms_split`)
and the partials summed in a fixed order; fp32 and fp16 run the FMA
kernel.

Given an :class:`Assembly` it returns the row norm instead, the main
paths' counterpart of ``repro/kernels/norm_assembly.py:37
assemble_norm_pallas``: the same launch ends by taking the Gram term
ba_sq = rowsum(BG ⊙ B) and assembling ``w_norm`` in K2's order, so no K2
launch, no [d_out, r] product and no row sum run beside it.

CUDA tensors launch the kernel or raise; CPU tensors run
:func:`norm_terms_plain`, then (with an assembly) the Gram row sum and
``norm_assembly.assemble_norm_plain``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import norm_assembly

_F32 = torch.float32

# The tensor-core kernel's block tile (csrc/norm_terms.cu, namespace k1):
# rows of d_out, rank columns, and the depth of one staged k-tile.
TILE_ROWS, TILE_RANK, TILE_K = 128, 192, 64
# Lanes that share one row's Gram sum in the epilogue (one warp).
GRAM_LANES = 32


class Assembly(NamedTuple):
    """K1's epilogue: the norm of W + s·B·A from the two terms, the Gram
    product ``BG`` = B32·(A32·A32ᵀ) (fp32 [d_out, r]) and, where given,
    ``base_sq`` (fp32 [d_out], the serving cache) in place of the summed
    base term."""
    BG: torch.Tensor
    s: float
    base_sq: torch.Tensor | None = None


def norm_terms_split(d_out: int, d_in: int, r: int) -> tuple[int, int]:
    """(splits, split_k) of d_in for the tensor-core kernel."""
    tiles = _build.cdiv(d_out, TILE_ROWS) * _build.cdiv(r, TILE_RANK)
    return _build.split_plan(tiles, d_in, TILE_K)


def norm_terms_plain(W, A, B):
    """Plain PyTorch version of the kernel's function."""
    W32 = W.to(_F32)
    U = W32 @ A.to(_F32).T
    return (W32 * W32).sum(dim=1), (B.to(_F32) * U).sum(dim=1)


def _assemble_plain(base_sq, cross, B, assembly: Assembly):
    """The epilogue's function on the plain terms."""
    if assembly.base_sq is not None:
        base_sq = assembly.base_sq.to(_F32)
    ba_sq = (assembly.BG * B.to(_F32)).sum(dim=1)
    return norm_assembly.assemble_norm_plain(base_sq, cross, ba_sq,
                                             assembly.s)


@_build.no_grad
def norm_terms(W, A, B, assembly: Assembly | None = None):
    """(base_sq, cross) fp32 [d_out] for W [d_out, d_in], A [r, d_in],
    B [d_out, r], all of one dtype (fp32, bf16 or fp16); with an
    ``assembly``, w_norm fp32 [d_out] instead."""
    if W.ndim != 2 or A.ndim != 2 or B.ndim != 2:
        raise ValueError("norm_terms takes 2-D W, A, B")
    d_out, d_in = W.shape
    r = A.shape[0]
    if A.shape[1] != d_in or tuple(B.shape) != (d_out, r):
        raise ValueError(f"norm_terms: shapes W {tuple(W.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)} do not "
                         f"agree (want A [r, d_in], B [d_out, r])")
    if assembly is not None and (
            tuple(assembly.BG.shape) != (d_out, r)
            or (assembly.base_sq is not None
                and tuple(assembly.base_sq.shape) != (d_out,))):
        raise ValueError(f"norm_terms: assembly BG {tuple(assembly.BG.shape)}"
                         f" or base_sq does not agree with d_out {d_out}, "
                         f"r {r}")
    if W.device.type == "cpu":
        base_sq, cross = norm_terms_plain(W, A, B)
        if assembly is None:
            return base_sq, cross
        return _assemble_plain(base_sq, cross, B, assembly)
    _build.check_operands("norm_terms", W, A, B, dtype=W.dtype)
    if assembly is not None:
        vecs = [assembly.BG] + ([] if assembly.base_sq is None
                                else [assembly.base_sq])
        _build.check_operands("norm_terms", W, *vecs)
        _build.check_operands("norm_terms", *vecs, dtype=_F32)
    code = _build.dtype_code("norm_terms", W)
    outs = [torch.empty(d_out, dtype=_F32, device=W.device)
            for _ in range(2 if assembly is None else 1)]
    if d_out == 0:
        return tuple(outs) if assembly is None else outs[0]
    split_k, scratch = 0, None
    if _build.tensor_cores(W, A, dims=(d_in,)) and d_in > 0 and r > 0:
        splits, split_k = norm_terms_split(d_out, d_in, r)
        rank_tiles = _build.cdiv(r, TILE_RANK)
        scratch = torch.empty(splits * (1 + rank_tiles) * d_out, dtype=_F32,
                              device=W.device)
    scratch_ptr = None if scratch is None else scratch.data_ptr()
    if assembly is None:
        rc = _build.library().norm_terms(
            W.data_ptr(), A.data_ptr(), B.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), scratch_ptr, d_out, d_in, r, split_k, code,
            _build.stream_of(W))
    else:
        two_s, s2 = norm_assembly.scalars(assembly.s)
        rc = _build.library().norm_terms_assemble(
            W.data_ptr(), A.data_ptr(), B.data_ptr(), assembly.BG.data_ptr(),
            None if assembly.base_sq is None else assembly.base_sq.data_ptr(),
            outs[0].data_ptr(), scratch_ptr, d_out, d_in, r, split_k, code,
            two_s, s2, _build.stream_of(W))
    _build.check(rc, "norm_terms")
    norm_terms.launches += 1
    if assembly is None:
        return tuple(outs)
    norm_terms.assembled_launches += 1
    return outs[0]


norm_terms.launches = 0
# The launches that ended in the epilogue (a subset of ``launches``).
norm_terms.assembled_launches = 0
