"""Wrappers the adapter calls around the kernels (counterpart of
``repro/kernels/ops.py``).

  - :func:`fused_norm`: the Gram product in plain matmuls, then one K1
    launch whose epilogue takes the Gram row sum and assembles the norm
    (K2's function); detached.
  - :func:`fused_compose`: a ``torch.autograd.Function`` on a materialized
    y_lora. Forward K4 (delta and the saved inner) when the magnitude
    gradient wants inner, else K3; backward K5 for d_base and d_lora, and
    d_g = Σ_rows dY⊙inner as a separate fp32 sum (paper §3.2: no atomics).
  - :func:`fused_compose_mm`: a ``torch.autograd.Function`` on the factored
    h = x·Aᵀ. Forward K6; backward K7 for d_base and d_h, then the cross
    product T = dYᵀ·h in fp32 (a plain matmul, as the reference leaves it
    outside its kernels) for d_B and the lora half of d_g.
    Given a mesh plan (``core/sharding.py ComposeSharding``) the same
    kernels run on each rank's [rows_local, d_out_local] tile: the
    forward needs no collective; the backward sums d_h over the d_out
    axes (unless the plan leaves that to its caller) and T and d_g's
    base term over the row axes.
  - :func:`scan_fn`: a ``torch.autograd.Function`` on the Mamba-1 scan.
    Forward K9 with its chunk states; backward the scan's backward kernel
    (``selective_scan_bwd``) for d_dt, d_dtx, d_B and d_C.

The kernels mask their ragged edges, so nothing is padded here. dY from
autograd may be non-contiguous; it is made contiguous before a launch.
Under layer remat each Function's forward runs twice a step (the layer's
forward and its recompute), and its launch counter shows both.
"""
from __future__ import annotations

import torch

from repro_torch.core.compose import f32
from repro_torch.core import sharding as _sh
from repro_torch.kernels.dora_compose import (compose_bwd, compose_fwd,
                                              compose_fwd_dual,
                                              compose_mm_bwd, compose_mm_fwd)
from repro_torch.kernels.factored_norm import Assembly, norm_terms
from repro_torch.kernels.selective_scan import (selective_scan,
                                                selective_scan_bwd)

_F32 = torch.float32


def _rows(x, n: int):
    return x.reshape(-1, n).contiguous()


class _Compose(torch.autograd.Function):
    """delta = (g-1)⊙base + g⊙s⊙lora; mirrors ``_make_compose``
    (``repro/kernels/ops.py:55-141``)."""

    @staticmethod
    def forward(ctx, base, lora, g, s, save_inner, mag_grad):
        n = base.shape[-1]
        g32 = g.to(_F32).reshape(n)
        gm1 = (g32 - 1.0).contiguous()
        if save_inner and mag_grad:
            delta, inner = compose_fwd_dual(_rows(base, n), _rows(lora, n),
                                            gm1, s)
            ctx.save_for_backward(g32, inner)
        else:
            delta = compose_fwd(_rows(base, n), _rows(lora, n), gm1, s)
            ctx.save_for_backward(*((g32, base, lora) if mag_grad
                                    else (g32,)))
        ctx.s, ctx.mag_grad = s, mag_grad
        return delta.reshape(base.shape)

    @staticmethod
    def backward(ctx, dy):
        g32, *res = ctx.saved_tensors
        s, n = ctx.s, dy.shape[-1]
        dy2 = _rows(dy, n)
        d_base, d_lora = compose_bwd(dy2, (g32 - 1.0).contiguous(),
                                     (g32 * f32(s)).contiguous())
        if not ctx.mag_grad:
            d_g = torch.zeros_like(g32)
        else:
            if len(res) == 1:
                inner32 = res[0].to(_F32)
            else:
                base, lora = res
                inner32 = (_rows(base, n).to(_F32)
                           + f32(s) * _rows(lora, n).to(_F32))
            d_g = (dy2.to(_F32) * inner32).sum(dim=0)
        return (d_base.reshape(dy.shape), d_lora.reshape(dy.shape), d_g,
                None, None, None)


class _ComposeMM(torch.autograd.Function):
    """delta = (g-1)⊙base + g⊙s⊙(h·Bᵀ); mirrors ``_make_compose_mm``
    (``repro/kernels/ops.py:156-224``). The residuals are tensors already
    live in the layer (h, B, base), so nothing extra is written for the
    backward.

    With a mesh ``plan`` (``_make_compose_mm_sharded``, ``:228``) base, h
    and dY are this rank's [rows_l, d_out_l] / [rows_l, r] tiles, B
    [d_out_l, r] and g [d_out_l] its d_out shard: the same kernels run on
    the local tile, the forward needs no collective, and the backward sums
    d_h over the d_out axes (``plan.psum_dh``), T = dY32ᵀ·h32 and d_g's
    base term over the row axes, all in fp32."""

    @staticmethod
    def forward(ctx, base, h, B, g, s, mag_grad, plan):
        n, r = base.shape[-1], h.shape[-1]
        g32 = g.to(_F32).reshape(n)
        delta = compose_mm_fwd(_rows(base, n), _rows(h, r), B.contiguous(),
                               (g32 - 1.0).contiguous(), s)
        ctx.save_for_backward(g32, h, B, base if mag_grad else None)
        ctx.s, ctx.mag_grad, ctx.plan = s, mag_grad, plan
        return delta.reshape(base.shape)

    @staticmethod
    def backward(ctx, dy):
        g32, h, B, base = ctx.saved_tensors
        s, n, r, plan = ctx.s, dy.shape[-1], h.shape[-1], ctx.plan

        def psum(x, axes, tag):
            return x if plan is None else _sh.psum(x, axes, plan.mesh,
                                                   tag=tag)

        rows = douts = ()
        if plan is not None:
            rows = plan.row_axes
            douts = plan.dout_axes if plan.psum_dh else ()
        gs = (g32 * f32(s)).contiguous()
        dy2 = _rows(dy, n)
        d_base, d_h = compose_mm_bwd(dy2, B.contiguous(),
                                     (g32 - 1.0).contiguous(), gs)
        d_h = psum(d_h, douts, "compose.d_h")
        # d_B = (g·s) ⊙ (dYᵀ·h): the one cross product the backward cannot
        # avoid; it also carries the lora half of d_g, so it is taken once.
        dy32 = dy2.to(_F32)
        T = psum(dy32.T @ _rows(h, r).to(_F32), rows,
                 "compose.T")                                  # [n, r]
        d_B = (gs[:, None] * T).to(B.dtype)
        if not ctx.mag_grad:
            d_g = torch.zeros_like(g32)
        else:
            # d_g = Σ_rows dY⊙(base + s·lora); the lora term contracts
            # through T: Σ_m dY⊙(h·Bᵀ) = rowsum(B ⊙ T).
            d_g = (psum((dy32 * _rows(base, n).to(_F32)).sum(dim=0), rows,
                        "compose.d_g")
                   + f32(s) * (B.to(_F32) * T).sum(dim=1))
        return (d_base.reshape(dy.shape), d_h.reshape(h.shape).to(h.dtype),
                d_B, d_g, None, None, None)


def fused_compose(base, lora, g, s: float, *, save_inner: bool = True,
                  mag_grad: bool = True):
    """delta = (g-1)⊙base + g⊙s⊙lora through K3/K4 forward and K5
    backward. base, lora [..., d_out]; g fp32 [d_out], differentiable
    unless ``mag_grad=False`` (the frozen-magnitude path, which also
    skips the inner save)."""
    return _Compose.apply(base, lora, g, float(s), bool(save_inner),
                          bool(mag_grad))


def fused_compose_mm(base, h, B, g, s: float, *, mag_grad: bool = True,
                     sharding=None):
    """delta = (g-1)⊙base + g⊙s⊙(h·Bᵀ) through K6 forward and K7
    backward. base [..., d_out], h = x·Aᵀ [..., r], B [d_out, r], g fp32
    [d_out]. The [..., d_out] y_lora is never materialized.

    ``sharding``: a :class:`~repro_torch.core.sharding.ComposeSharding`;
    the tensors are then this rank's shards under it and the kernels run
    shard-local with the plan's sums in the backward. A plan whose B is
    sharded beyond the output's d_out, or whose local d_out breaks the
    128-lane rule, is refused (the reference drops such a plan; its
    dispatch routes it to the materialized lora, and so does the port's)."""
    if base.shape[:-1] != h.shape[:-1]:
        raise ValueError(f"base leading dims {tuple(base.shape[:-1])} != "
                         f"h leading dims {tuple(h.shape[:-1])}")
    if sharding is not None:
        if any(a not in sharding.dout_axes for a in sharding.b_dout_axes):
            raise ValueError(
                f"fused_compose_mm cannot run shard-local with B sharded "
                f"beyond the output d_out: b_spec={sharding.b_spec} "
                f"(b_dout_axes={sharding.b_dout_axes}) vs output spec "
                f"{sharding.out_spec} — the plan is inexpressible; use the "
                f"materialized-lora route instead")
        if B.shape[0] != base.shape[-1]:
            raise ValueError(f"B {tuple(B.shape)} is not congruent with "
                             f"the local d_out {base.shape[-1]}")
        if not sharding.kernel_expressible(base.shape[-1]
                                           * sharding.dout_shards):
            raise ValueError(
                f"local d_out {base.shape[-1]} breaks the 128-lane block "
                f"constraint (paper App. C, applied per shard)")
    return _ComposeMM.apply(base, h, B, g, float(s), bool(mag_grad),
                            sharding)


class _Scan(torch.autograd.Function):
    """(y, h_f) of the selective scan; the gradients of dt, dtx, Bm and
    Cm. The reference differentiates only those: it wraps A_log in
    ``stop_gradient`` and starts training from h0 = 0, and its final state
    feeds no loss, so h_f is marked non-differentiable. The residuals are
    the inputs and K9's chunk states, [B, ceil(S / 32), n, di] fp32; under
    layer remat they live for one layer at a time."""

    @staticmethod
    def forward(ctx, dt, dtx, Bm, Cm, A_t, h0_t):
        y, h_f, hc = selective_scan(dt, dtx, Bm, Cm, A_t, h0_t,
                                    chunk_states=True)
        ctx.save_for_backward(dt, dtx, Bm, Cm, A_t, hc)
        ctx.mark_non_differentiable(h_f)
        return y, h_f

    @staticmethod
    def backward(ctx, dy, _dh_f):
        dt, dtx, Bm, Cm, A_t, hc = ctx.saved_tensors
        d_dt, d_dtx, d_B, d_C = selective_scan_bwd(dt, dtx, Bm, Cm, A_t, hc,
                                                   dy.contiguous())
        return d_dt, d_dtx, d_B, d_C, None, None


def scan_fn(dt, dtx, Bm, Cm, A_t, h0_t):
    """The selective scan in K9's layout (``kernels/selective_scan.py``)
    under autograd: forward K9 with chunk states, backward its backward
    kernel (their plain versions on CPU tensors). A_t and h0_t take no
    gradient, as in the reference; one that requires it is refused."""
    for name, t in (("A_t", A_t), ("h0_t", h0_t)):
        if t.requires_grad:
            raise ValueError(
                f"scan_fn: {name} requires grad, but the scan has no "
                f"gradient for it: the reference wraps A_log in "
                f"jax.lax.stop_gradient and trains from h0 = 0 "
                f"(repro/models/mamba.py) — detach it")
    return _Scan.apply(dt, dtx, Bm, Cm, A_t, h0_t)


@torch.no_grad()
def fused_norm(W, A, B, s: float, *, base_sq_cache=None):
    """Detached fp32 row-wise norm of W + s·B·A through K1 and its
    epilogue (K2's assembly)."""
    if s == 0.0:
        if base_sq_cache is not None:
            return torch.sqrt(torch.clamp_min(base_sq_cache, 0.0))
        w32 = W.to(_F32)
        return torch.sqrt(torch.clamp_min((w32 * w32).sum(dim=1), 0.0))
    A32 = A.to(_F32)
    G = A32 @ A32.T                                   # [r, r]
    BG = B.to(_F32) @ G                               # [d_out, r]
    if base_sq_cache is not None:
        base_sq_cache = base_sq_cache.to(_F32).contiguous()
    return norm_terms(W.contiguous(), A.contiguous(), B.contiguous(),
                      Assembly(BG, s, base_sq_cache))
