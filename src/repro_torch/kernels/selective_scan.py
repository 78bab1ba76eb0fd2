"""K9: the Mamba-1 selective scan.

Replaces ``repro/kernels/selective_scan.py:60 selective_scan_pallas``
(``_scan_kernel`` :37, the ``pallas_call`` :71):

    h_t = exp(dt_t ⊙ A) ⊙ h_{t-1} + (dtx_t) ⊗ B_t,    y_t = Σ_n h_t ⊙ C_t

in the Pallas function's layout (kernel: ``csrc/selective_scan.cu``). It
takes any S (no ``S % chunk`` rule: the model prefills at the exact
prompt length), any di, and n ≤ :data:`MAX_STATE`. CUDA tensors launch the
kernel or raise; CPU tensors run :func:`selective_scan_plain`.

The kernel splits each (batch, channel) pair's :data:`MAX_STATE` states
over :data:`LANES` lanes of a warp (:func:`scan_schedule`), computes each
exp as ``exp2(dt · A·log2(e))`` in one SFU op, and sums y over the lanes
in a fixed xor tree.

Training: ``chunk_states=True`` also returns the state at every boundary
of :data:`STATE_EVERY` steps, and :func:`selective_scan_bwd` (kernel:
``csrc/selective_scan_bwd.cu``; no TPU counterpart, the reference
differentiates its XLA scan) walks the chunks backwards from them to the
gradients of dt, dtx, Bm and Cm: :data:`BWD_LANES` lanes a channel
(:func:`bwd_schedule`), h recomputed from hc to the start of every
:data:`BWD_WINDOW`-step window and then window by window in registers.
``repro_torch.kernels.ops.scan_fn`` is the autograd Function over the
pair.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_F32 = torch.float32

MAX_STATE = 16          # the largest n the kernel holds in registers
SCAN_THREADS = 128      # threads a block
# Lanes that share one (batch, channel) pair, MAX_STATE / LANES states
# each: 1, 2 or 4 (the fastest of chip_smoke.py's sweep on the H100).
LANES = 2
# Steps between the states the training forward keeps (hc[:, k] is h
# before step k * STATE_EVERY), where the backward restarts its recompute.
STATE_EVERY = 32


def scan_schedule(batch: int, di: int, lanes: int) -> tuple[int, int, int]:
    """(blocks along di, blocks along the batch, channels a block) of the
    kernel's grid: thread t of block (x, b) holds channel
    x * channels + t // lanes of batch row b, and states
    (t % lanes) * MAX_STATE / lanes onward; channels >= di are masked."""
    if lanes not in (1, 2, 4):
        raise ValueError(f"selective_scan: lanes = {lanes}, expected 1, 2 "
                         f"or 4")
    channels = SCAN_THREADS // lanes
    return _build.cdiv(di, channels), batch, channels


def _check(dt, dtx, Bm, Cm, A_t, h0_t=None, hc=None, dy=None) -> None:
    """Shapes of the scan's operands: the forward's h0_t, or the
    backward's hc and dy."""
    if dt.ndim != 3 or Bm.ndim != 3 or A_t.ndim != 2:
        raise ValueError("selective scan takes dt, dtx [B, S, di], Bm, Cm "
                         "[B, S, n], A_t [n, di] and h0_t [B, n, di]")
    b, s, di = dt.shape
    n = A_t.shape[0]
    want = {"dtx": (dtx, (b, s, di)), "Bm": (Bm, (b, s, n)),
            "Cm": (Cm, (b, s, n)), "A_t": (A_t, (n, di)),
            "h0_t": (h0_t, (b, n, di)),
            "hc": (hc, (b, chunk_count(s), n, di)), "dy": (dy, (b, s, di))}
    for name, (t, shape) in want.items():
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"selective scan: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape} (dt "
                             f"{tuple(dt.shape)}, n {n})")


def chunk_count(seq: int) -> int:
    """Entries of the chunk-state output along S: ceil(S / STATE_EVERY)."""
    return _build.cdiv(seq, STATE_EVERY)


def selective_scan_plain(dt, dtx, Bm, Cm, A_t, h0_t, *, chunk_states=False):
    """Plain PyTorch version of the kernel's function: the reference
    recurrence as a loop over t, in the same layout. Returns (y [B, S, di],
    h_f [B, n, di]) in fp32, and with ``chunk_states`` also hc [B,
    ceil(S / STATE_EVERY), n, di], the state before every
    STATE_EVERY-th step."""
    _check(dt, dtx, Bm, Cm, A_t, h0_t)
    h = h0_t.to(_F32)
    A_t = A_t.to(_F32)
    ys, kept = [], []
    for t in range(dt.shape[1]):
        if t % STATE_EVERY == 0:
            kept.append(h)
        a = torch.exp(dt[:, t, None, :].to(_F32) * A_t)           # [B,n,di]
        h = a * h + dtx[:, t, None, :].to(_F32) * Bm[:, t, :, None]
        ys.append((h * Cm[:, t, :, None]).sum(dim=1))
    if ys:
        y = torch.stack(ys, dim=1)
    else:
        y, h = dt.new_zeros(dt.shape, dtype=_F32), h.clone()
    if not chunk_states:
        return y, h
    hc = (torch.stack(kept, dim=1) if kept
          else h.new_zeros((h.shape[0], 0, *h.shape[1:])))
    return y, h, hc


@_build.no_grad
def selective_scan(dt, dtx, Bm, Cm, A_t, h0_t, *, chunk_states=False):
    """dt, dtx [B, S, di]; Bm, Cm [B, S, n]; A_t [n, di]; h0_t [B, n, di],
    all fp32 → (y [B, S, di], h_f [B, n, di]) fp32, and with
    ``chunk_states`` also hc [B, ceil(S / STATE_EVERY), n, di] fp32 (a
    separate instantiation of the kernel; without it the serving kernel
    runs as before)."""
    _check(dt, dtx, Bm, Cm, A_t, h0_t)
    if dt.device.type == "cpu":
        return selective_scan_plain(dt, dtx, Bm, Cm, A_t, h0_t,
                                    chunk_states=chunk_states)
    _build.check_operands("selective_scan", dt, dtx, Bm, Cm, A_t, h0_t,
                          dtype=_F32)
    b, s, di = dt.shape
    n = A_t.shape[0]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan: state size n = {n} is not "
                         f"supported (1 <= n <= {MAX_STATE})")
    y = torch.empty((b, s, di), dtype=_F32, device=dt.device)
    h_f = torch.empty((b, n, di), dtype=_F32, device=dt.device)
    hc = (torch.empty((b, chunk_count(s), n, di), dtype=_F32,
                      device=dt.device) if chunk_states else None)
    out = (y, h_f, hc) if chunk_states else (y, h_f)
    if b == 0 or di == 0:
        return out
    rc = _build.library().selective_scan(
        dt.data_ptr(), dtx.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        A_t.data_ptr(), h0_t.data_ptr(), y.data_ptr(), h_f.data_ptr(),
        hc.data_ptr() if chunk_states else None, STATE_EVERY, b, s, di, n,
        LANES, _build.stream_of(dt))
    _build.check(rc, "selective_scan")
    selective_scan.launches += 1
    return out


selective_scan.launches = 0


# ---------------------------------------------------------------------------
# The backward (no TPU kernel: the reference differentiates its XLA scan).
# ---------------------------------------------------------------------------

BWD_THREADS = 256      # threads a block of the backward kernel
# Lanes that share one (batch, channel) pair in the backward kernel,
# MAX_STATE / BWD_LANES states each: 4 or 8 (the faster of chip_smoke.py's
# sweep on the H100).
BWD_LANES = 4
# Steps a window of the backward holds in registers: a chunk of
# STATE_EVERY steps is recomputed from hc to each window's start, then
# window by window, last to first.
BWD_WINDOW = 8


def bwd_schedule(batch: int, di: int, lanes: int) -> tuple[int, int, int]:
    """(blocks along di, blocks along the batch, channels a block) of the
    backward kernel's grid: thread t of block (x, b) holds channel
    x * channels + t // lanes of batch row b and states
    (t % lanes) * MAX_STATE / lanes onward. The blocks along di are the
    rows of its d_B and d_C partials."""
    if lanes not in (4, 8):
        raise ValueError(f"selective_scan_bwd: lanes = {lanes}, expected 4 "
                         f"or 8")
    channels = BWD_THREADS // lanes
    return _build.cdiv(di, channels), batch, channels


def selective_scan_bwd_plain(dt, dtx, Bm, Cm, A_t, hc, dy):
    """Plain PyTorch version of the backward kernel's function, in its
    layout: chunks of STATE_EVERY steps walked from last to first, h
    recomputed over each from hc, then the reverse recurrence
    g_t = a_{t+1}·g_{t+1} + dy_t ⊗ C_t stepped back through it. Returns
    (d_dt, d_dtx [B, S, di], d_B, d_C [B, S, n]) in fp32."""
    _check(dt, dtx, Bm, Cm, A_t, hc=hc, dy=dy)
    dt, dtx, Bm, Cm, A_t, hc, dy = (t.to(_F32) for t in
                                    (dt, dtx, Bm, Cm, A_t, hc, dy))
    b, s, di = dt.shape
    d_dt, d_dtx = torch.zeros_like(dt), torch.zeros_like(dtx)
    d_B, d_C = torch.zeros_like(Bm), torch.zeros_like(Cm)
    g = hc.new_zeros((b, A_t.shape[0], di))               # g_{t+1}
    a_next = torch.zeros_like(g)                          # a_{t+1}
    for k in reversed(range(chunk_count(s))):
        t0, t1 = k * STATE_EVERY, min(s, (k + 1) * STATE_EVERY)
        hs = [hc[:, k]]                                   # h_{t0-1} ..
        for t in range(t0, t1):
            a = torch.exp(dt[:, t, None, :] * A_t)
            hs.append(a * hs[-1] + dtx[:, t, None, :] * Bm[:, t, :, None])
        for t in reversed(range(t0, t1)):
            g = a_next * g + dy[:, t, None, :] * Cm[:, t, :, None]
            a_next = torch.exp(dt[:, t, None, :] * A_t)
            d_dt[:, t] = (g * A_t * a_next * hs[t - t0]).sum(dim=1)
            d_dtx[:, t] = (g * Bm[:, t, :, None]).sum(dim=1)
            d_B[:, t] = (g * dtx[:, t, None, :]).sum(dim=2)
            d_C[:, t] = (hs[t - t0 + 1] * dy[:, t, None, :]).sum(dim=2)
    return d_dt, d_dtx, d_B, d_C


@_build.no_grad
def selective_scan_bwd(dt, dtx, Bm, Cm, A_t, hc, dy):
    """dt, dtx, dy [B, S, di]; Bm, Cm [B, S, n]; A_t [n, di]; hc [B,
    ceil(S / STATE_EVERY), n, di] from ``selective_scan(...,
    chunk_states=True)``, all fp32 → (d_dt, d_dtx, d_B, d_C) fp32. One
    launch of the main kernel and of its partial sum, counted once."""
    _check(dt, dtx, Bm, Cm, A_t, hc=hc, dy=dy)
    if dt.device.type == "cpu":
        return selective_scan_bwd_plain(dt, dtx, Bm, Cm, A_t, hc, dy)
    _build.check_operands("selective_scan_bwd", dt, dtx, Bm, Cm, A_t, hc,
                          dy, dtype=_F32)
    b, s, di = dt.shape
    n = A_t.shape[0]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan_bwd: state size n = {n} is not "
                         f"supported (1 <= n <= {MAX_STATE})")
    d_dt, d_dtx = torch.empty_like(dt), torch.empty_like(dtx)
    if b == 0 or s == 0 or di == 0:
        return d_dt, d_dtx, torch.zeros_like(Bm), torch.zeros_like(Cm)
    d_B, d_C = torch.empty_like(Bm), torch.empty_like(Cm)
    blocks, _, _ = bwd_schedule(b, di, BWD_LANES)
    part = torch.empty((2, blocks, b, s, n), dtype=_F32, device=dt.device)
    rc = _build.library().selective_scan_bwd(
        dt.data_ptr(), dtx.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        A_t.data_ptr(), hc.data_ptr(), dy.data_ptr(), d_dt.data_ptr(),
        d_dtx.data_ptr(), d_B.data_ptr(), d_C.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), STATE_EVERY, b, s, di, n, BWD_LANES,
        _build.stream_of(dt))
    _build.check(rc, "selective_scan_bwd")
    selective_scan_bwd.launches += 1
    return d_dt, d_dtx, d_B, d_C


selective_scan_bwd.launches = 0
