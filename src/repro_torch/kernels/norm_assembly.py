"""K2: norm assembly (paper Eq. 5).

Replaces ``repro/kernels/norm_assembly.py:37 assemble_norm_pallas``:

    w_norm = sqrt(max(base_sq + two_s·cross + s2·ba_sq, 0))   fp32 [d_out]

with two_s = 2s and s2 = s² formed in fp64 and rounded to fp32, the adds
in that order, a NaN-propagating max and a correctly rounded sqrt
(kernel: ``csrc/assemble_norm.cu``). CUDA tensors launch the kernel or
raise; CPU tensors run :func:`assemble_norm_plain`. The main paths run the
same arithmetic as K1's epilogue (``factored_norm.Assembly``), not this
kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core.compose import f32
from repro_torch.kernels import _build

_F32 = torch.float32


def scalars(s: float) -> tuple[float, float]:
    s64 = float(s)
    return f32(2.0 * s64), f32(s64 * s64)


def assemble_norm_plain(base_sq, cross, ba_sq, s: float):
    """Plain PyTorch version of the kernel's function, in its order."""
    two_s, s2 = scalars(s)
    acc = base_sq + two_s * cross
    acc = acc + s2 * ba_sq
    return torch.sqrt(torch.clamp_min(acc, 0.0))


@_build.no_grad
def assemble_norm(base_sq, cross, ba_sq, s: float):
    """base_sq, cross, ba_sq: fp32 [d_out] → w_norm fp32 [d_out]."""
    if base_sq.ndim != 1 or cross.shape != base_sq.shape \
            or ba_sq.shape != base_sq.shape:
        raise ValueError("assemble_norm takes three fp32 [d_out] vectors "
                         "of one length")
    if base_sq.device.type == "cpu":
        return assemble_norm_plain(base_sq, cross, ba_sq, s)
    _build.check_operands("assemble_norm", base_sq, cross, ba_sq, dtype=_F32)
    (n,) = base_sq.shape
    out = torch.empty(n, dtype=_F32, device=base_sq.device)
    if n == 0:
        return out
    two_s, s2 = scalars(s)
    rc = _build.library().assemble_norm(
        base_sq.data_ptr(), cross.data_ptr(), ba_sq.data_ptr(),
        out.data_ptr(), n, two_s, s2, _build.stream_of(base_sq))
    _build.check(rc, "assemble_norm")
    assemble_norm.launches += 1
    return out


assemble_norm.launches = 0
