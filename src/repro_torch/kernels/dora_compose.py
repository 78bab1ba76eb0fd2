"""K3 and K6: the stable DoRA compose, forward only (paper §3.1).

  - K3 :func:`compose_fwd` replaces ``repro/kernels/dora_compose.py:106
    compose_fwd_pallas`` with ``save_inner=False``: delta = gm1⊙base +
    (gm1+1)⊙(s·lora) for base, lora [M, N] (kernel: ``csrc/compose.cu``).
  - K6 :func:`compose_mm_fwd` replaces ``dora_compose.py:211
    compose_mm_fwd_pallas``: the same compose with lora = h·Bᵀ computed
    inside the kernel, so the [M, N] y_lora is never written (kernel:
    ``csrc/compose_mm.cu``). r is taken as given, without padding.

gm1 = g − 1 is an fp32 [N] vector formed outside the kernels. CUDA
tensors launch the kernel or raise; CPU tensors run the plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.core.compose import f32
from repro_torch.kernels import _build

_F32 = torch.float32


def _compose_plain(base, lora32, gm1, s: float):
    t = f32(s) * lora32                          # s·lora first
    return (gm1 * base.to(_F32) + (gm1 + 1.0) * t).to(base.dtype)


def compose_fwd_plain(base, lora, gm1, s: float):
    """Plain PyTorch version of K3's function, in its order."""
    return _compose_plain(base, lora.to(_F32), gm1.to(_F32), s)


def compose_mm_fwd_plain(base, h, B, gm1, s: float):
    """Plain PyTorch version of K6's function: fp32 up-projection, then
    the compose in K3's order."""
    return _compose_plain(base, h.to(_F32) @ B.to(_F32).T, gm1.to(_F32), s)


def _check_gm1(kernel, gm1, n):
    if gm1.ndim != 1 or gm1.shape[0] != n:
        raise ValueError(f"{kernel}: gm1 must be [N] = [{n}], got "
                         f"{tuple(gm1.shape)}")


@torch.no_grad()
def compose_fwd(base, lora, gm1, s: float):
    """delta [M, N] in base's dtype from base, lora [M, N] and fp32 gm1
    [N]."""
    if base.ndim != 2 or lora.shape != base.shape:
        raise ValueError(f"compose_fwd: base and lora must be one [M, N] "
                         f"shape, got {tuple(base.shape)} and "
                         f"{tuple(lora.shape)}")
    m, n = base.shape
    _check_gm1("compose_fwd", gm1, n)
    if base.device.type == "cpu":
        return compose_fwd_plain(base, lora, gm1, s)
    _build.check_operands("compose_fwd", base, lora, dtype=base.dtype)
    _build.check_operands("compose_fwd", base, gm1)
    if gm1.dtype != _F32:
        raise TypeError(f"compose_fwd: gm1 must be fp32, got {gm1.dtype}")
    code = _build.dtype_code("compose_fwd", base)
    out = torch.empty_like(base)
    if base.numel() == 0:
        return out
    vec = 16 // base.element_size()
    if n % vec or any(t.data_ptr() % 16 for t in (base, lora, out)):
        vec = 1
    rc = _build.library().compose_fwd(
        base.data_ptr(), lora.data_ptr(), gm1.data_ptr(), out.data_ptr(),
        m, n, f32(s), vec, code, _build.stream_of(base))
    _build.check(rc, "compose_fwd")
    compose_fwd.launches += 1
    return out


compose_fwd.launches = 0


@torch.no_grad()
def compose_mm_fwd(base, h, B, gm1, s: float):
    """delta [M, N] in base's dtype from base [M, N], h [M, r], B [N, r]
    and fp32 gm1 [N]."""
    if base.ndim != 2 or h.ndim != 2 or B.ndim != 2:
        raise ValueError("compose_mm_fwd takes 2-D base, h, B")
    m, n = base.shape
    r = h.shape[1]
    if h.shape[0] != m or tuple(B.shape) != (n, r):
        raise ValueError(f"compose_mm_fwd: shapes base {tuple(base.shape)}"
                         f", h {tuple(h.shape)}, B {tuple(B.shape)} do not "
                         f"agree (want h [M, r], B [N, r])")
    _check_gm1("compose_mm_fwd", gm1, n)
    if base.device.type == "cpu":
        return compose_mm_fwd_plain(base, h, B, gm1, s)
    _build.check_operands("compose_mm_fwd", base, h, B, dtype=base.dtype)
    _build.check_operands("compose_mm_fwd", base, gm1)
    if gm1.dtype != _F32:
        raise TypeError(f"compose_mm_fwd: gm1 must be fp32, got "
                        f"{gm1.dtype}")
    code = _build.dtype_code("compose_mm_fwd", base)
    out = torch.empty_like(base)
    if base.numel() == 0:
        return out
    rc = _build.library().compose_mm_fwd(
        base.data_ptr(), h.data_ptr(), B.data_ptr(), gm1.data_ptr(),
        out.data_ptr(), m, n, r, f32(s), code, _build.stream_of(base))
    _build.check(rc, "compose_mm_fwd")
    compose_mm_fwd.launches += 1
    return out


compose_mm_fwd.launches = 0
