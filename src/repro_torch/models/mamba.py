"""Mamba-1 selective SSM block (counterpart of ``repro/models/mamba.py``),
for the falcon-mamba layers.

Every step keeps the reference's dtypes: ``in_proj`` (DoRA-adapted) and
``x_proj`` in the model dtype; the causal conv accumulated in fp32 and
cast back; ``dt_proj``, ``dt_bias``, ``A = -exp(A_log)`` and
``dtx = dt · x`` in fp32; the scan, the D skip and the gate in fp32, cast
back before ``out_proj`` (DoRA-adapted).

The scan runs through :func:`~repro_torch.core.dispatch.plan_scan`: K9
(``kernels/selective_scan.py``) on the kernel route, its plain version on
the eager route. The reference's ``ssm_impl`` picks one of two XLA
lowerings ("fused_chunk", "assoc") of the same recurrence; the port runs
its one scan for either value. A one-token step (``S == 1``, decode)
keeps the reference's one-step update in plain torch.

Decode carries ``{"h": [B, di, n] fp32, "conv": [B, k-1, di]}`` per
layer.

Training: as in the reference, only the DoRA adapters of ``in_proj`` and
``out_proj`` train (the conv, ``x_proj``, ``dt_proj``, ``dt_bias``,
``A_log`` and ``skip_d`` are detached, the reference's
``stop_gradient``). With grad enabled the kernel route runs the scan
through :func:`~repro_torch.kernels.ops.scan_fn` (K9 with chunk states,
then the scan's backward kernel), and the eager route through autograd of
the plain loop.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.config import DoRAConfig
from repro_torch.core.dispatch import plan_scan
from repro_torch.kernels.ops import scan_fn
from repro_torch.kernels.selective_scan import (selective_scan,
                                                selective_scan_plain)
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

_F32 = torch.float32


def causal_conv(x, w, b, cache=None):
    """Depthwise causal conv over the sequence as k shifted adds in fp32.

    x [B, S, di]; w [k, di]; b [di]; cache [B, k-1, di] (decode) or None.
    Returns (y [B, S, di] in x's dtype, new_cache [B, k-1, di])."""
    k = w.shape[0]
    if cache is None:
        ctx = F.pad(x, (0, 0, k - 1, 0))
    else:
        ctx = torch.cat([cache.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = torch.zeros(x.shape, dtype=_F32, device=x.device)
    for j in range(k):
        y = y + w[j].to(_F32) * ctx[:, j:j + S].to(_F32)
    y = y + b.to(_F32)
    new_cache = ctx[:, ctx.shape[1] - (k - 1):]
    return y.to(x.dtype), new_cache


def ssm_scan(dt, dtx, Bm, Cm, A, h0, dcfg: DoRAConfig | None):
    """h_t = exp(dt_t A) ⊙ h_{t-1} + (dtx_t) ⊗ B_t;  y_t = Σ_n h_t C_t.

    dt, dtx [B, S, di] fp32; Bm, Cm [B, S, n] fp32; A [di, n]; h0
    [B, di, n]. Returns (y [B, S, di], h_final [B, di, n]). S == 1 is the
    reference's one-step update; longer sequences run K9 (or its plain
    version on the eager route) in its [n, di] state layout, through
    :func:`scan_fn` where a gradient is wanted."""
    if dt.shape[1] == 1:
        a = torch.exp(dt[:, 0, :, None] * A)
        b = dtx[:, 0, :, None] * Bm[:, 0, None, :]
        h = a * h0 + b
        y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])
        return y[:, None], h
    plan = plan_scan(dcfg, device=dt.device)
    scan = selective_scan if plan.fused else selective_scan_plain
    if plan.fused and torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, dtx, Bm, Cm)):
        scan = scan_fn
    y, h_t = scan(dt.contiguous(), dtx.contiguous(), Bm.contiguous(),
                  Cm.contiguous(), A.T.contiguous(),
                  h0.transpose(1, 2).contiguous())
    return y, h_t.transpose(1, 2)


def mamba_block(x, p, dora, mcfg: ModelConfig, dcfg: DoRAConfig | None, *,
                cache=None, training: bool = True):
    """x [B, S, D] → (y [B, S, D], new_cache or None).

    p: {"in_proj": [2di, D], "conv_w": [k, di], "conv_b": [di],
        "x_proj": [dtr+2n, di], "dt_proj": [di, dtr], "dt_bias": [di],
        "A_log": [di, n], "skip_d": [di], "out_proj": [D, di]}.
    ``cache``: {"h", "conv"} of this layer or None; the new state is
    returned, not written (the caller writes it in place)."""
    di, n, dtr = mcfg.d_inner, mcfg.ssm_state, mcfg.dt_rank
    dora = dora or {}
    xz = L.maybe_dora(x, p["in_proj"], dora.get("in_proj"), dcfg,
                      training=training)                      # [B, S, 2di]
    xi, z = xz.split(di, dim=-1)
    xi, new_conv = causal_conv(xi, p["conv_w"].detach(),
                               p["conv_b"].detach(),
                               cache["conv"] if cache is not None else None)
    xi = F.silu(xi)

    bcdt = xi @ p["x_proj"].detach().T                        # [B,S,dtr+2n]
    dt_in, Bm, Cm = bcdt.to(_F32).split([dtr, n, n], dim=-1)
    dt = F.softplus(dt_in @ p["dt_proj"].detach().to(_F32).T
                    + p["dt_bias"].detach().to(_F32))        # [B, S, di]
    A = -torch.exp(p["A_log"].detach().to(_F32))              # [di, n]
    B = x.shape[0]
    h0 = (cache["h"].to(_F32) if cache is not None
          else torch.zeros((B, di, n), dtype=_F32, device=x.device))
    xi32 = xi.to(_F32)
    y, h_f = ssm_scan(dt, dt * xi32, Bm, Cm, A, h0, dcfg)
    y = y + p["skip_d"].detach().to(_F32) * xi32
    y = y * F.silu(z.to(_F32))
    y = y.to(x.dtype)

    out = L.maybe_dora(y, p["out_proj"], dora.get("out_proj"), dcfg,
                       training=training)
    new_cache = None
    if cache is not None:
        new_cache = {"h": h_f, "conv": new_conv}
    return out, new_cache
