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


def _check(dt, dtx, Bm, Cm, A_t, h0_t) -> None:
    if dt.ndim != 3 or Bm.ndim != 3 or A_t.ndim != 2 or h0_t.ndim != 3:
        raise ValueError("selective scan takes dt, dtx [B, S, di], Bm, Cm "
                         "[B, S, n], A_t [n, di] and h0_t [B, n, di]")
    b, s, di = dt.shape
    n = A_t.shape[0]
    want = {"dtx": (dtx, (b, s, di)), "Bm": (Bm, (b, s, n)),
            "Cm": (Cm, (b, s, n)), "A_t": (A_t, (n, di)),
            "h0_t": (h0_t, (b, n, di))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"selective scan: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape} (dt "
                             f"{tuple(dt.shape)}, n {n})")


def selective_scan_plain(dt, dtx, Bm, Cm, A_t, h0_t):
    """Plain PyTorch version of the kernel's function: the reference
    recurrence as a loop over t, in the same layout. Returns (y [B, S, di],
    h_f [B, n, di]) in fp32."""
    _check(dt, dtx, Bm, Cm, A_t, h0_t)
    h = h0_t.to(_F32)
    A_t = A_t.to(_F32)
    ys = []
    for t in range(dt.shape[1]):
        a = torch.exp(dt[:, t, None, :].to(_F32) * A_t)           # [B,n,di]
        h = a * h + dtx[:, t, None, :].to(_F32) * Bm[:, t, :, None]
        ys.append((h * Cm[:, t, :, None]).sum(dim=1))
    if not ys:
        return dt.new_zeros(dt.shape, dtype=_F32), h.clone()
    return torch.stack(ys, dim=1), h


@_build.no_grad
def selective_scan(dt, dtx, Bm, Cm, A_t, h0_t):
    """dt, dtx [B, S, di]; Bm, Cm [B, S, n]; A_t [n, di]; h0_t [B, n, di],
    all fp32 → (y [B, S, di], h_f [B, n, di]) fp32."""
    _check(dt, dtx, Bm, Cm, A_t, h0_t)
    if dt.device.type == "cpu":
        return selective_scan_plain(dt, dtx, Bm, Cm, A_t, h0_t)
    _build.check_operands("selective_scan", dt, dtx, Bm, Cm, A_t, h0_t,
                          dtype=_F32)
    b, s, di = dt.shape
    n = A_t.shape[0]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan: state size n = {n} is not "
                         f"supported (1 <= n <= {MAX_STATE})")
    y = torch.empty((b, s, di), dtype=_F32, device=dt.device)
    h_f = torch.empty((b, n, di), dtype=_F32, device=dt.device)
    if b == 0 or di == 0:
        return y, h_f
    rc = _build.library().selective_scan(
        dt.data_ptr(), dtx.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        A_t.data_ptr(), h0_t.data_ptr(), y.data_ptr(), h_f.data_ptr(), b, s,
        di, n, LANES, _build.stream_of(dt))
    _build.check(rc, "selective_scan")
    selective_scan.launches += 1
    return y, h_f


selective_scan.launches = 0
