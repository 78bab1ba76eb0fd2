"""K3–K7: the stable DoRA compose, forward and backward (paper §3.1, §3.2).

  - K3 :func:`compose_fwd` replaces ``repro/kernels/dora_compose.py:106
    compose_fwd_pallas`` with ``save_inner=False``: delta = gm1⊙base +
    (gm1+1)⊙(s·lora) for base, lora [M, N] (kernel: ``csrc/compose.cu``).
  - K4 :func:`compose_fwd_dual` replaces the same function with
    ``save_inner=True``: delta and inner = base + s·lora, the residual of
    the magnitude gradient (kernel: ``csrc/compose.cu``).
  - K5 :func:`compose_bwd` replaces ``dora_compose.py:136
    compose_bwd_pallas``: d_base = gm1⊙dY and d_lora = gs⊙dY in one pass
    (kernel: ``csrc/compose_bwd.cu``).
  - K6 :func:`compose_mm_fwd` replaces ``dora_compose.py:211
    compose_mm_fwd_pallas``: the compose with lora = h·Bᵀ computed inside
    the kernel, so the [M, N] y_lora is never written (kernel:
    ``csrc/compose_mm.cu``). r is taken as given, without padding. bf16
    runs on the tensor cores: a persistent grid
    (:func:`compose_mm_fwd_blocks`) of [128 x 192] output tiles, fed and
    drained by TMA, each tile written by one block.
  - K7 :func:`compose_mm_bwd` replaces ``dora_compose.py:239
    compose_mm_bwd_pallas``: d_base = gm1⊙dY and the fp32
    d_h = (gs⊙dY)·B in one pass over dY (kernel: ``csrc/compose_mm_bwd.cu``;
    bf16 runs on the tensor cores with N split across blocks,
    :func:`compose_mm_bwd_split`, and the partials summed in a fixed
    order).

gm1 = g − 1 and gs = g·s are fp32 [N] vectors formed outside the kernels.
CUDA tensors launch the kernel or raise; CPU tensors run the plain
versions.
"""
from __future__ import annotations

import torch

from repro_torch.core.compose import f32
from repro_torch.kernels import _build

_F32 = torch.float32

# K6's tensor-core output tile (csrc/compose_mm.cu, namespace k6): rows
# and columns of delta.
MM_FWD_TILE_ROWS, MM_FWD_TILE_COLS = 128, 192

# K7's tensor-core block tile (csrc/compose_mm_bwd.cu, namespace k7): rows
# of dY, rank columns, and the depth (columns of dY) of one staged tile.
MM_BWD_TILE_ROWS, MM_BWD_TILE_RANK, MM_BWD_TILE_K = 128, 192, 64


def _compose_plain(base, lora32, gm1, s: float, *, inner: bool = False):
    t = f32(s) * lora32                          # s·lora first
    b32 = base.to(_F32)
    delta = (gm1 * b32 + (gm1 + 1.0) * t).to(base.dtype)
    return (delta, (b32 + t).to(base.dtype)) if inner else delta


def compose_fwd_plain(base, lora, gm1, s: float):
    """Plain PyTorch version of K3's function, in its order."""
    return _compose_plain(base, lora.to(_F32), gm1.to(_F32), s)


def compose_fwd_dual_plain(base, lora, gm1, s: float):
    """Plain PyTorch version of K4's function: (delta, inner)."""
    return _compose_plain(base, lora.to(_F32), gm1.to(_F32), s, inner=True)


def compose_bwd_plain(dy, gm1, gs):
    """Plain PyTorch version of K5's function: (d_base, d_lora)."""
    dy32 = dy.to(_F32)
    return (gm1.to(_F32) * dy32).to(dy.dtype), (gs.to(_F32) * dy32).to(
        dy.dtype)


def compose_mm_fwd_plain(base, h, B, gm1, s: float):
    """Plain PyTorch version of K6's function: fp32 up-projection, then
    the compose in K3's order."""
    return _compose_plain(base, h.to(_F32) @ B.to(_F32).T, gm1.to(_F32), s)


def compose_mm_bwd_plain(dy, B, gm1, gs):
    """Plain PyTorch version of K7's function: (d_base, fp32 d_h)."""
    dy32 = dy.to(_F32)
    return ((gm1.to(_F32) * dy32).to(dy.dtype),
            (gs.to(_F32) * dy32) @ B.to(_F32))


def compose_mm_fwd_blocks(m: int, n: int) -> int:
    """Blocks of K6's persistent tensor-core grid: one per SM, at most one
    per output tile. Block b writes tiles b, b + blocks, b + 2·blocks, ...
    of the row-major [128 x 192] tiling of [M, N]."""
    tiles = _build.cdiv(m, MM_FWD_TILE_ROWS) * _build.cdiv(n,
                                                            MM_FWD_TILE_COLS)
    return min(_build.SMS, tiles)


def compose_mm_bwd_split(m: int, n: int, r: int) -> tuple[int, int]:
    """(splits, split_n) of N for K7's tensor-core kernel."""
    tiles = (_build.cdiv(m, MM_BWD_TILE_ROWS)
             * _build.cdiv(r, MM_BWD_TILE_RANK))
    return _build.split_plan(tiles, n, MM_BWD_TILE_K)


def _check_vec(kernel, v, n, name="gm1"):
    if v.ndim != 1 or v.shape[0] != n:
        raise ValueError(f"{kernel}: {name} must be [N] = [{n}], got "
                         f"{tuple(v.shape)}")


def _check_matrices(kernel, *mats):
    if any(t.ndim != 2 for t in mats) or any(t.shape != mats[0].shape
                                             for t in mats):
        raise ValueError(f"{kernel}: operands must be one [M, N] shape, "
                         f"got {[tuple(t.shape) for t in mats]}")


def _check_cuda(kernel, mats, vecs, dtype):
    """One CUDA device and contiguity for all; ``dtype`` for the
    matrices, fp32 for the [N] vectors. Returns the dtype code."""
    _build.check_operands(kernel, *mats, *vecs)
    for t in mats:
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: operands must share dtype {dtype}, "
                            f"got {t.dtype}")
    for v in vecs:
        if v.dtype != _F32:
            raise TypeError(f"{kernel}: [N] vectors must be fp32, got "
                            f"{v.dtype}")
    return _build.dtype_code(kernel, mats[0])


def _vec_width(n: int, *tensors) -> int:
    """16-byte vectors when N and every pointer allow them, else 1."""
    vec = 16 // tensors[0].element_size()
    if n % vec or any(t.data_ptr() % 16 for t in tensors):
        return 1
    return vec


@_build.no_grad
def compose_fwd(base, lora, gm1, s: float):
    """delta [M, N] in base's dtype from base, lora [M, N] and fp32 gm1
    [N]."""
    _check_matrices("compose_fwd", base, lora)
    m, n = base.shape
    _check_vec("compose_fwd", gm1, n)
    if base.device.type == "cpu":
        return compose_fwd_plain(base, lora, gm1, s)
    code = _check_cuda("compose_fwd", (base, lora), (gm1,), base.dtype)
    out = torch.empty_like(base)
    if base.numel() == 0:
        return out
    rc = _build.library().compose_fwd(
        base.data_ptr(), lora.data_ptr(), gm1.data_ptr(), out.data_ptr(),
        m, n, f32(s), _vec_width(n, base, lora, out), code,
        _build.stream_of(base))
    _build.check(rc, "compose_fwd")
    compose_fwd.launches += 1
    return out


compose_fwd.launches = 0


@_build.no_grad
def compose_fwd_dual(base, lora, gm1, s: float):
    """(delta, inner) [M, N] in base's dtype from base, lora [M, N] and
    fp32 gm1 [N]; inner = base + s·lora."""
    _check_matrices("compose_fwd_dual", base, lora)
    m, n = base.shape
    _check_vec("compose_fwd_dual", gm1, n)
    if base.device.type == "cpu":
        return compose_fwd_dual_plain(base, lora, gm1, s)
    code = _check_cuda("compose_fwd_dual", (base, lora), (gm1,), base.dtype)
    out = torch.empty_like(base)
    inner = torch.empty_like(base)
    if base.numel() == 0:
        return out, inner
    rc = _build.library().compose_fwd_dual(
        base.data_ptr(), lora.data_ptr(), gm1.data_ptr(), out.data_ptr(),
        inner.data_ptr(), m, n, f32(s), _vec_width(n, base, lora, out, inner),
        code, _build.stream_of(base))
    _build.check(rc, "compose_fwd_dual")
    compose_fwd_dual.launches += 1
    return out, inner


compose_fwd_dual.launches = 0


@_build.no_grad
def compose_bwd(dy, gm1, gs):
    """(d_base, d_lora) [M, N] in dY's dtype from dY [M, N] and fp32 gm1,
    gs [N]."""
    _check_matrices("compose_bwd", dy)
    m, n = dy.shape
    _check_vec("compose_bwd", gm1, n)
    _check_vec("compose_bwd", gs, n, "gs")
    if dy.device.type == "cpu":
        return compose_bwd_plain(dy, gm1, gs)
    code = _check_cuda("compose_bwd", (dy,), (gm1, gs), dy.dtype)
    d_base = torch.empty_like(dy)
    d_lora = torch.empty_like(dy)
    if dy.numel() == 0:
        return d_base, d_lora
    rc = _build.library().compose_bwd(
        dy.data_ptr(), gm1.data_ptr(), gs.data_ptr(), d_base.data_ptr(),
        d_lora.data_ptr(), m, n, _vec_width(n, dy, d_base, d_lora), code,
        _build.stream_of(dy))
    _build.check(rc, "compose_bwd")
    compose_bwd.launches += 1
    return d_base, d_lora


compose_bwd.launches = 0


def _check_mm(kernel, mat, h_or_none, B):
    m, n = mat.shape
    r = B.shape[1]
    if (h_or_none is not None and tuple(h_or_none.shape) != (m, r)) \
            or B.shape[0] != n or r == 0:
        raise ValueError(
            f"{kernel}: shapes [M, N] {tuple(mat.shape)}, "
            + ("" if h_or_none is None else f"h {tuple(h_or_none.shape)}, ")
            + f"B {tuple(B.shape)} do not agree (want h [M, r], B [N, r], "
            f"r > 0)")
    return m, n, r


@_build.no_grad
def compose_mm_fwd(base, h, B, gm1, s: float):
    """delta [M, N] in base's dtype from base [M, N], h [M, r], B [N, r]
    and fp32 gm1 [N]."""
    if base.ndim != 2 or h.ndim != 2 or B.ndim != 2:
        raise ValueError("compose_mm_fwd takes 2-D base, h, B")
    m, n, r = _check_mm("compose_mm_fwd", base, h, B)
    _check_vec("compose_mm_fwd", gm1, n)
    if base.device.type == "cpu":
        return compose_mm_fwd_plain(base, h, B, gm1, s)
    code = _check_cuda("compose_mm_fwd", (base, h, B), (gm1,), base.dtype)
    out = torch.empty_like(base)
    if base.numel() == 0:
        return out
    blocks = 0
    if _build.tensor_cores(base, h, B, gm1, out, dims=(n, r)):
        blocks = compose_mm_fwd_blocks(m, n)
    rc = _build.library().compose_mm_fwd(
        base.data_ptr(), h.data_ptr(), B.data_ptr(), gm1.data_ptr(),
        out.data_ptr(), m, n, r, f32(s), blocks, code,
        _build.stream_of(base))
    _build.check(rc, "compose_mm_fwd")
    compose_mm_fwd.launches += 1
    if blocks:
        compose_mm_fwd.mma_launches += 1
    return out


compose_mm_fwd.launches = 0
# Of those launches, the ones that took the tensor-core kernel.
compose_mm_fwd.mma_launches = 0


@_build.no_grad
def compose_mm_bwd(dy, B, gm1, gs):
    """(d_base [M, N] in dY's dtype, fp32 d_h [M, r]) from dY [M, N],
    B [N, r] and fp32 gm1, gs [N]."""
    if dy.ndim != 2 or B.ndim != 2:
        raise ValueError("compose_mm_bwd takes 2-D dY and B")
    m, n, r = _check_mm("compose_mm_bwd", dy, None, B)
    _check_vec("compose_mm_bwd", gm1, n)
    _check_vec("compose_mm_bwd", gs, n, "gs")
    if dy.device.type == "cpu":
        return compose_mm_bwd_plain(dy, B, gm1, gs)
    code = _check_cuda("compose_mm_bwd", (dy, B), (gm1, gs), dy.dtype)
    d_base = torch.empty_like(dy)
    d_h = torch.empty((m, r), dtype=_F32, device=dy.device)
    if dy.numel() == 0:
        return d_base, d_h.zero_()
    split_n, scratch = 0, None
    if _build.tensor_cores(dy, B, gm1, gs, d_base, dims=(n, r)):
        splits, split_n = compose_mm_bwd_split(m, n, r)
        if splits > 1:
            scratch = torch.empty((splits, m, r), dtype=_F32,
                                  device=dy.device)
    rc = _build.library().compose_mm_bwd(
        dy.data_ptr(), B.data_ptr(), gm1.data_ptr(), gs.data_ptr(),
        d_base.data_ptr(), d_h.data_ptr(),
        None if scratch is None else scratch.data_ptr(), m, n, r, split_n,
        code, _build.stream_of(dy))
    _build.check(rc, "compose_mm_bwd")
    compose_mm_bwd.launches += 1
    return d_base, d_h


compose_mm_bwd.launches = 0
