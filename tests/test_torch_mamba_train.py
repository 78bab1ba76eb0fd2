"""Mamba training in the port against the reference.

The reference trains Mamba by ``jax.grad`` through its XLA scan
(``repro/models/mamba.py:50 _ssm_scan_fused``); the port runs K9 with its
chunk states forward and the scan's backward kernel
(``kernels/selective_scan.py``: ``selective_scan_bwd``, whose plain
version runs here on CPU tensors) through the autograd Function
``kernels.ops.scan_fn``.

  - ``selective_scan_bwd_plain`` and ``scan_fn`` against ``jax.grad``
    through ``_ssm_scan_fused`` for d_dt, d_dtx, d_Bm and d_Cm: several
    seeds, S ragged against both the chunk-state stride (32) and the
    reference's unroll, n = 16 and n < 16, B > 1, S = 1; the chunk states
    of the training forward; the refusals (A_t or h0_t requiring grad);
  - ``mamba_block`` under autograd against ``jax.grad`` of the reference's
    ``mamba_block`` (adapter and input gradients), on the kernel route
    (``scan_fn``) and the eager route (autograd of the plain loop), and
    layer remat against none;
  - falcon-mamba SMOKE: the port's gradients and three train steps
    against the reference's, from its perturbed params through the
    bridge; the train CLI on ``--device cpu``.

Tolerances (fp32), scaled to the reference's largest magnitude: the
scan's gradients 1e-5 (K9's tolerance); block and model adapter
gradients 1e-4; losses 1e-5 relative; AdamW's eps raised to 1e-4 as in
``tests/test_torch_train.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.config import DoRAConfig as JConfig
from repro.launch.steps import StepConfig as JStep
from repro.launch.steps import cross_entropy as j_cross_entropy
from repro.launch.steps import make_train_step as j_make_train_step
from repro.launch.train import build_state
from repro.models import lm as jlm
from repro.models import mamba as jmamba
from repro.models.config import ModelConfig as JModel
from repro.optim import OptimizerConfig as JOpt
from repro_torch import kernels as tkernels
from repro_torch.bridge import flatten_paths, tree_from_numpy, tree_to_numpy
from repro_torch.configs import get_config
from repro_torch.core.config import FORCE_TIER_ENV, DoRAConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import selective_scan as tk_scan
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import mamba as tmamba
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimizerConfig, adamw_init

RANK, ALPHA = 16, 32.0
SCAN_REL, GRAD_REL, LOSS_REL = 1e-5, 1e-4, 1e-5
BLOCK_WIDTHS = dict(name="mamba-block", family="ssm", num_layers=1,
                    d_model=128, num_heads=0, num_kv_heads=0, d_ff=0,
                    vocab_size=64, ssm=True, ssm_state=16)


@pytest.fixture(autouse=True)
def _no_forced_tier(monkeypatch):
    for name in ("REPRO_FORCE_TIER", "REPRO_DORA_MODE", "REPRO_DORA_FUSED",
                 FORCE_TIER_ENV):
        monkeypatch.delenv(name, raising=False)


def _rel(got, want) -> float:
    got = (got.detach().double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float64))
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# --- the scan's backward ------------------------------------------------------

def _scan_case(seed, B, S, di, n):
    """dt in the Mamba init's range, dtx, B, C, A < 0 in the reference's
    model layout (A [di, n]), and the loss weights w on y, numpy fp32."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dt = np.exp(np.log(1e-3) + rng.uniform(0, np.log(300.0), (B, S, di))
                ).astype(np.float32)
    dtx = (dt * f(B, S, di)).astype(np.float32)
    A = -np.exp(0.5 * f(di, n)).astype(np.float32)
    return dt, dtx, f(B, S, n), f(B, S, n), A, f(B, S, di)


def _jax_scan_grads(dt, dtx, Bm, Cm, A, w, unroll):
    """jax.grad of Σ y·w through the reference's scan, from h0 = 0."""
    h0 = jnp.zeros((dt.shape[0], A.shape[0], A.shape[1]), jnp.float32)

    def loss(dt, dtx, Bm, Cm):
        y, _ = jmamba._ssm_scan_fused(dt, dtx, Bm, Cm, jnp.asarray(A), h0,
                                      unroll)
        return jnp.sum(y * jnp.asarray(w))

    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (dt, dtx, Bm, Cm)))


SCAN_CASES = [  # (seed, B, S, di, n, the reference's unroll)
    (0, 1, 37, 64, 16, 8),      # S ragged against 32 and 8
    (1, 2, 70, 48, 4, 16),      # n < 16, B > 1, three chunk states
    (2, 2, 64, 32, 16, 16),     # S a multiple of both
    (3, 3, 33, 40, 8, 5),       # one step past a boundary, unroll 5
    (4, 2, 1, 24, 16, 8),       # S = 1 (the reference's one-step path)
    (5, 1, 45, 72, 16, 8),      # ragged against the backward's tiling:
                                # di against 64 and 32 channels a block,
                                # S against 8-step windows and 32
]


@pytest.mark.parametrize("seed,B,S,di,n,unroll", SCAN_CASES)
def test_scan_bwd_plain_matches_jax_grad(seed, B, S, di, n, unroll):
    dt, dtx, Bm, Cm, A, w = _scan_case(seed, B, S, di, n)
    want = _jax_scan_grads(dt, dtx, Bm, Cm, A, w, unroll)
    t = [torch.from_numpy(a) for a in (dt, dtx, Bm, Cm)]
    A_t = torch.from_numpy(np.ascontiguousarray(A.T))
    h0_t = torch.zeros(B, n, di)
    _, _, hc = tk_scan.selective_scan(*t, A_t, h0_t, chunk_states=True)
    assert hc.shape == (B, -(-S // tk_scan.STATE_EVERY), n, di)
    tkernels.reset_launch_counts()
    got = tk_scan.selective_scan_bwd(*t, A_t, hc, torch.from_numpy(w))
    assert sum(tkernels.launch_counts().values()) == 0
    for name, g, jg in zip(("dt", "dtx", "Bm", "Cm"), got, want):
        assert g.dtype == torch.float32
        assert _rel(g, jg) <= SCAN_REL, name


@pytest.mark.parametrize("seed,B,S,di,n,unroll", SCAN_CASES)
def test_scan_fn_matches_jax_grad(seed, B, S, di, n, unroll):
    """The autograd Function: y equal to the serving scan's, gradients
    against jax.grad."""
    dt, dtx, Bm, Cm, A, w = _scan_case(seed + 10, B, S, di, n)
    want = _jax_scan_grads(dt, dtx, Bm, Cm, A, w, unroll)
    t = [torch.from_numpy(a).requires_grad_(True) for a in (dt, dtx, Bm, Cm)]
    A_t = torch.from_numpy(np.ascontiguousarray(A.T))
    h0_t = torch.zeros(B, n, di)
    y, h_f = tops.scan_fn(*t, A_t, h0_t)
    y_serve, h_serve = tk_scan.selective_scan(*(x.detach() for x in t), A_t,
                                              h0_t)
    assert torch.equal(y.detach(), y_serve) and torch.equal(h_f, h_serve)
    assert y.requires_grad and not h_f.requires_grad
    (y * torch.from_numpy(w)).sum().backward()
    for name, x, jg in zip(("dt", "dtx", "Bm", "Cm"), t, want):
        assert _rel(x.grad, jg) <= SCAN_REL, name


def test_chunk_states_are_the_state_before_every_stride():
    dt, dtx, Bm, Cm, A, _ = _scan_case(7, 2, 75, 16, 4)
    t = [torch.from_numpy(a) for a in (dt, dtx, Bm, Cm)]
    A_t = torch.from_numpy(np.ascontiguousarray(A.T))
    h0_t = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 4, 16)).astype(np.float32))
    y, h_f, hc = tk_scan.selective_scan(*t, A_t, h0_t, chunk_states=True)
    assert torch.equal(hc[:, 0], h0_t)
    for k in (1, 2):
        cut = k * tk_scan.STATE_EVERY
        _, h_k = tk_scan.selective_scan(*(x[:, :cut] for x in t), A_t, h0_t)
        assert torch.equal(hc[:, k], h_k)
    y2, h2 = tk_scan.selective_scan(*t, A_t, h0_t)
    assert torch.equal(y, y2) and torch.equal(h_f, h2)


def test_scan_fn_refuses_a_gradient_for_A_and_h0():
    dt, dtx, Bm, Cm, A, _ = _scan_case(8, 1, 5, 16, 4)
    t = [torch.from_numpy(a) for a in (dt, dtx, Bm, Cm)]
    A_t = torch.from_numpy(np.ascontiguousarray(A.T))
    h0_t = torch.zeros(1, 4, 16)
    with pytest.raises(ValueError, match="A_t requires grad.*stop_gradient"):
        tops.scan_fn(*t, A_t.clone().requires_grad_(True), h0_t)
    with pytest.raises(ValueError, match="h0_t requires grad.*stop_gradient"):
        tops.scan_fn(*t, A_t, h0_t.clone().requires_grad_(True))


def test_scan_bwd_wrapper_checks_shapes_and_never_falls_back():
    dt, dtx, Bm, Cm, A, w = _scan_case(9, 1, 40, 16, 4)
    t = [torch.from_numpy(a) for a in (dt, dtx, Bm, Cm)]
    A_t = torch.from_numpy(np.ascontiguousarray(A.T))
    hc = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="hc has shape"):
        tk_scan.selective_scan_bwd(*t, A_t, hc[:, :1], torch.from_numpy(w))
    with pytest.raises(ValueError, match="dy has shape"):
        tk_scan.selective_scan_bwd(*t, A_t, hc, torch.from_numpy(w)[:, 1:])
    meta = [torch.empty(x.shape, device="meta")
            for x in (*t, A_t, hc, torch.from_numpy(w))]
    with pytest.raises(RuntimeError, match="CUDA unavailable"):
        tk_scan.selective_scan_bwd(*meta)
    assert tkernels.KERNELS["selective_scan_bwd"] is tk_scan.selective_scan_bwd


def _tree(x):
    """Sum over the last dim in the kernels' xor-tree order: pairs of
    neighbours first (index bit 0), then pairs of pairs."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _xor_reduce_scatter(v, masks):
    """csrc/selective_scan_bwd.cu's ``lane_sum`` and ``channel_sum`` over
    one warp, in torch: v [32 lanes, k]; at each mask m a lane keeps the
    odd or even values as its bit m is set or not and adds those of lane
    ^ m. Returns each lane's remaining values [32, k / 2**len(masks)]."""
    lanes = torch.arange(32)
    for m in masks:
        up = (lanes & m) != 0
        lo, hi = v[:, 0::2], v[:, 1::2]
        send = torch.where(up[:, None], lo, hi)
        v = torch.where(up[:, None], hi, lo) + send[lanes ^ m]
    return v


def _slots(lanes):
    """The backward kernel's slot order: slot j of lane L·c + g of a warp
    holds state g·kS + (j ^ (c % kS)) [32, kS]."""
    ks = 16 // lanes
    return torch.tensor([[(lane % lanes) * ks + (j ^ (lane // lanes % ks))
                          for j in range(ks)] for lane in range(32)])


def _channel_sum(v, lanes):
    """csrc/selective_scan_bwd.cu ``channel_sum`` in torch: v [32 lanes,
    2·kS] (d_B's slots, then d_C's); at every mask below 16 a lane keeps
    its even values and adds its partner's odd ones; at mask 16 it keeps
    d_B or d_C as bit 16 is clear or set. Returns each lane's sum [32]."""
    lanes_ = torch.arange(32)
    m = lanes
    while m < 16:
        v = v[:, 0::2] + v[lanes_ ^ m, 1::2]
        m <<= 1
    up = (lanes_ & 16) != 0
    keep = torch.where(up, v[:, 1], v[:, 0])
    send = torch.where(up, v[:, 0], v[:, 1])
    return keep + send[lanes_ ^ 16]


@pytest.mark.parametrize("lanes", [4, 8])
def test_backward_channel_sum_gives_each_state_one_lane(lanes):
    """The backward kernel's d_B and d_C sum over a warp's 32 / lanes
    channels (lane L·c + g holds the products of channel c, d_B's then
    d_C's, in its slot order): lane l ends with quantity (l // L) // kS
    of state (l % L)·kS + (l // L) % kS; the 32 lanes hold every
    (quantity, state) once, each the xor tree over the channels (bitwise:
    the same sums as a reduce-scatter with selects over states in order)
    and within fp32 rounding of the plain sum."""
    ks, cw = 16 // lanes, 32 // lanes
    rng = np.random.default_rng(3 + lanes)
    p = torch.from_numpy(rng.standard_normal((2, cw, 16)).astype(np.float32))
    slots = _slots(lanes)
    v = torch.stack([torch.cat([p[q, lane // lanes, slots[lane]]
                                for q in (0, 1)]) for lane in range(32)])
    got = _channel_sum(v, lanes)[:, None]
    plain_order = torch.stack([torch.cat([p[q, lane // lanes, (lane % lanes)
                                            * ks:(lane % lanes + 1) * ks]
                                          for q in (0, 1)])
                               for lane in range(32)])
    assert torch.equal(got, _xor_reduce_scatter(
        plain_order, [lanes << k for k in range(cw.bit_length() - 1)]))
    held = []
    for lane in range(32):
        cq = lane // lanes
        q, i = cq // ks, (lane % lanes) * ks + cq % ks
        held.append((q, i))
        assert torch.equal(got[lane, 0], _tree(p[q, :, i]))
        want = p[q, :, i].double().sum().item()
        assert abs(got[lane, 0].item() - want) <= 1e-5 * p.abs().max().item()
    assert sorted(held) == [(q, i) for q in (0, 1) for i in range(16)]


@pytest.mark.parametrize("lanes", [4, 8])
def test_backward_lane_sum_gives_each_step_one_lane(lanes):
    """d_dt and d_dtx sum over a channel's lanes: each lane holds its
    partial sums of ``lanes`` consecutive steps; after masks 1 .. L / 2
    lane g of each channel holds step g's sum (every step once), the xor
    tree over the lanes, within fp32 rounding of the plain sum."""
    rng = np.random.default_rng(11 + lanes)
    p = torch.from_numpy(rng.standard_normal((32 // lanes, lanes, lanes))
                         .astype(np.float32))       # [channel, lane, step]
    v = p.reshape(32, lanes)
    masks = [1 << k for k in range(lanes.bit_length() - 1)]
    got = _xor_reduce_scatter(v, masks)
    assert got.shape == (32, 1)
    for lane in range(32):
        ch, g = divmod(lane, lanes)
        assert torch.equal(got[lane, 0], _tree(p[ch, :, g]))
        want = p[ch, :, g].double().sum().item()
        assert abs(got[lane, 0].item() - want) <= 1e-5 * p.abs().max().item()


def _bwd_schedule(dt, dtx, Bm, Cm, A_t, hc, dy, lanes):
    """csrc/selective_scan_bwd.cu's schedule and summation order in torch
    (fp32; exps by exp2(dt·A·log2 e)): states padded to 16 and di to the
    block's channels; chunks last to first; in each, the pass from hc to
    the start of every window, then the windows last to first, each
    recomputed and walked back; d_dt and d_dtx summed over a lane's states
    in order, then over the lanes in the xor tree (d_dt scaled by ln 2);
    d_B and d_C over a warp's channels in the xor tree, the block's warps
    in order, then the blocks in index order. A lane takes its states in
    its slot order (``_slots``), and carries a_{t+1}·g_{t+1}."""
    b, s, di = dt.shape
    n = A_t.shape[0]
    blocks, _, ch = tk_scan.bwd_schedule(b, di, lanes)
    ks, cw = 16 // lanes, 32 // lanes
    # State of slot j of lane g of every channel: [lanes, ks, dp].
    x = torch.arange(blocks * ch) % cw % ks
    slot = torch.stack([torch.stack([g * ks + (j ^ x) for j in range(ks)])
                        for g in range(lanes)])
    win, tc = tk_scan.BWD_WINDOW, tk_scan.STATE_EVERY
    chunks = tk_scan.chunk_count(s)
    sp, dp = chunks * tc, blocks * ch
    pad = lambda x, *p: torch.nn.functional.pad(x, p)
    dt, dtx, dy = (pad(x, 0, dp - di, 0, sp - s) for x in (dt, dtx, dy))
    Bm, Cm = (pad(x, 0, 16 - n, 0, sp - s) for x in (Bm, Cm))
    a2 = pad(A_t, 0, dp - di, 0, 16 - n) * np.float32(1.4426950408889634)
    hc = pad(hc, 0, dp - di, 0, 16 - n)

    def lane_sum(v):                        # [b, 16, dp] -> [b, dp]
        acc = torch.zeros(b, lanes, dp)
        for j in range(ks):                 # a lane's slots in order
            acc = acc + v.gather(1, slot[:, j].expand(b, lanes, dp))
        return _tree(acc.transpose(1, 2))

    def channel_sum(x):                     # [b, 16, dp] -> [b, 16]
        x = _tree(x.reshape(b, 16, blocks, 8, cw))
        part = torch.zeros(b, 16, blocks)
        for wp in range(8):
            part = part + x[..., wp]
        out = torch.zeros(b, 16)
        for x_ in range(blocks):
            out = out + part[..., x_]
        return out

    outs = [torch.zeros(b, sp, dp), torch.zeros(b, sp, dp),
            torch.zeros(b, sp, 16), torch.zeros(b, sp, 16)]
    ag = torch.zeros(b, 16, dp)             # a_{t+1}·g_{t+1}
    for k in reversed(range(chunks)):
        t0 = k * tc
        nwin = -(-min(tc, s - t0) // win)

        def step(t, h):
            a = torch.exp2(dt[:, t, None, :] * a2)
            return a, a * h + dtx[:, t, None, :] * Bm[:, t, :, None]

        starts = [hc[:, k]]
        for w in range(nwin - 1):
            h = starts[-1]
            for u in range(win):
                h = step(t0 + w * win + u, h)[1]
            starts.append(h)
        for w in reversed(range(nwin)):
            aw, hw = [], []
            for u in range(win):
                a, h = step(t0 + w * win + u, hw[-1] if hw else starts[w])
                aw.append(a)
                hw.append(h)
            for u in reversed(range(win)):
                t = t0 + w * win + u
                dyv, dxv = dy[:, t, None, :], dtx[:, t, None, :]
                gr = dyv * Cm[:, t, :, None] + ag
                ag = aw[u] * gr
                hp = hw[u - 1] if u else starts[w]
                outs[0][:, t] = lane_sum((ag * hp) * a2) \
                    * np.float32(0.6931471805599453)
                outs[1][:, t] = lane_sum(gr * Bm[:, t, :, None])
                outs[2][:, t] = channel_sum(gr * dxv)
                outs[3][:, t] = channel_sum(hw[u] * dyv)
    return (outs[0][:, :s, :di], outs[1][:, :s, :di], outs[2][:, :s, :n],
            outs[3][:, :s, :n])


@pytest.mark.parametrize("lanes", [4, 8])
@pytest.mark.parametrize("seed,B,S,di,n", [
    (12, 1, 45, 72, 16),     # di ragged against 64 and 32 channels, S 45
    (13, 2, 70, 40, 4),      # n < 16, three chunks, the last of 6 steps
])
def test_backward_schedule_matches_plain_and_jax_grad(seed, B, S, di, n,
                                                      lanes):
    """The kernel's schedule (windows of BWD_WINDOW steps recomputed from
    the pass's starts, g carried across windows and chunks, the sums in
    the kernel's orders) gives the plain version's gradients and
    jax.grad's, within 1e-5 of max |grad| each."""
    dt, dtx, Bm, Cm, A, w = _scan_case(seed, B, S, di, n)
    want = _jax_scan_grads(dt, dtx, Bm, Cm, A, w, 8)
    t = [torch.from_numpy(a) for a in (dt, dtx, Bm, Cm)]
    A_t = torch.from_numpy(np.ascontiguousarray(A.T))
    _, _, hc = tk_scan.selective_scan(*t, A_t, torch.zeros(B, n, di),
                                      chunk_states=True)
    dy = torch.from_numpy(w)
    got = _bwd_schedule(*t, A_t, hc, dy, lanes)
    plain = tk_scan.selective_scan_bwd_plain(*t, A_t, hc, dy)
    for name, g, p, jg in zip(("dt", "dtx", "Bm", "Cm"), got, plain, want):
        assert g.shape == p.shape
        assert _rel(g, p.numpy()) <= SCAN_REL, name
        assert _rel(g, jg) <= SCAN_REL, name


def test_backward_schedule_fills_the_card():
    """At the falcon-mamba-7b training shape [2, 2048, 8192] the backward
    runs more than 1,024 warps at each lane count (the first design ran
    1,024, one 4-warp block an SM); its partials have a row per block
    along di."""
    for lanes, warps in ((4, 2048), (8, 4096)):
        blocks, rows, ch = tk_scan.bwd_schedule(2, 8192, lanes)
        assert blocks * ch == 8192 and rows == 2
        assert blocks * rows * tk_scan.BWD_THREADS // 32 == warps
    assert tk_scan.bwd_schedule(1, 8232, 4)[0] == 129
    with pytest.raises(ValueError, match="lanes = 2"):
        tk_scan.bwd_schedule(1, 64, 2)


# --- the block ----------------------------------------------------------------

def _perturb(adapters, rng):
    for name, leaf in flatten_paths(adapters).items():
        if name.endswith("/B"):
            leaf[...] = 0.05 * rng.standard_normal(leaf.shape)
        elif name.endswith("/m"):
            leaf *= 1 + 0.01 * rng.standard_normal(leaf.shape).astype(
                np.float32)
    return adapters


def _np_state(jm, seed):
    params, adapters, _ = build_state(jm, JConfig(rank=RANK, alpha=ALPHA),
                                      seed)
    params = jax.tree_util.tree_map(np.array, params)
    adapters = jax.tree_util.tree_map(np.array, adapters)
    return params, _perturb(adapters, np.random.default_rng(seed))


@pytest.mark.parametrize("route", ["fused", "eager"])
def test_mamba_block_grads_match_reference(route, monkeypatch):
    """Adapter and input gradients of the block (S = 45, ragged against
    both the chunk-state stride and the reference's unroll of 16) against
    jax.grad of the reference's; the kernel route's scan goes through
    scan_fn (K9's plain version with chunk states, then the backward's),
    the eager route's through autograd of the plain loop."""
    calls: dict = {}
    for name in ("selective_scan_plain", "selective_scan_bwd_plain"):
        fn = getattr(tk_scan, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(tk_scan, name, wrapped)
    if route == "eager":     # the eager route binds the plain scan at import
        monkeypatch.setattr(tmamba, "selective_scan_plain",
                            tk_scan.selective_scan_plain)
    jm = JModel(**BLOCK_WIDTHS, dtype=jnp.float32)
    tm = ModelConfig(**BLOCK_WIDTHS, dtype=torch.float32)
    params, adapters = _np_state(jm, 5)
    layer = lambda tree: jax.tree_util.tree_map(lambda a: a[0],
                                                tree["stack"]["l0"])["mixer"]
    p, a = layer(params), layer(adapters)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 45, 128)).astype(np.float32)
    w = rng.standard_normal((2, 45, 128)).astype(np.float32)
    jcfg = JConfig(rank=RANK, alpha=ALPHA, mode="eager")

    def jloss(a, xx):
        y, _ = jmamba.mamba_block(xx, jax.tree_util.tree_map(jnp.asarray, p),
                                  a, jm, jcfg, training=True)
        return jnp.sum(y * jnp.asarray(w))

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, a), jnp.asarray(x))
    ta = tree_from_numpy(a)
    for leaf in flatten_paths(ta).values():
        leaf.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = tmamba.mamba_block(xt, tree_from_numpy(p), ta, tm,
                              DoRAConfig(rank=RANK, alpha=ALPHA, mode=route),
                              training=True)
    (y * torch.from_numpy(w)).sum().backward()
    want = flatten_paths(jax.tree_util.tree_map(np.asarray, jg))
    got = flatten_paths(ta)
    assert set(got) == set(want)
    for name in want:
        assert _rel(got[name].grad, want[name]) <= GRAD_REL, name
    assert _rel(xt.grad, jgx) <= GRAD_REL
    if route == "fused":
        assert calls == {"selective_scan_plain": 1,
                         "selective_scan_bwd_plain": 1}
    else:
        assert calls == {"selective_scan_plain": 1}


# --- the whole model: falcon-mamba SMOKE ----------------------------------------

SEQ, BATCH, STEPS = 40, 2, 3


def _smoke_state():
    jm = j_get_config("falcon-mamba-7b", smoke=True)
    params, adapters = _np_state(jm, 0)
    return jm, get_config("falcon-mamba-7b", smoke=True), params, adapters


def _batches(steps=STEPS, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, 256, (steps, BATCH, SEQ + 1)).astype(np.int32)
    return [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]


def _ref_grads(jm, params, adapters, batch, jcfg, loss_tokens):
    def loss_fn(a):
        logits, _, aux = jlm.forward(jm, params, a, jcfg,
                                     tokens=jnp.asarray(batch["tokens"]),
                                     training=True, loss_slice=loss_tokens)
        return j_cross_entropy(
            logits, jnp.asarray(batch["labels"])[:, -loss_tokens:]) + aux
    return jax.value_and_grad(loss_fn)(adapters)


@pytest.mark.parametrize("route", ["fused", "eager"])
def test_smoke_gradients_match_reference(route):
    """The falcon-mamba SMOKE loss and adapter gradients (2 layers, layer
    remat, loss on the last 24 tokens) against jax.grad of the
    reference's forward; remat and no remat give the same gradients."""
    jm, tm, params, adapters = _smoke_state()
    batch = _batches(1)[0]
    jcfg = JConfig(rank=RANK, alpha=ALPHA, mode="eager")
    jloss, jg = _ref_grads(jm, jax.tree_util.tree_map(jnp.asarray, params),
                           jax.tree_util.tree_map(jnp.asarray, adapters),
                           batch, jcfg, 24)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    dcfg = DoRAConfig(rank=RANK, alpha=ALPHA, mode=route)
    out = {}
    for remat in ("layer", "none"):
        loss, g = tsteps.make_grad_step(
            dataclasses.replace(tm, remat=remat),
            tsteps.StepConfig(dora=dcfg, loss_tokens=24), batch=BATCH,
            seq=SEQ)(tree_from_numpy(params), tree_from_numpy(adapters), tb)
        out[remat] = (float(loss), flatten_paths(tree_to_numpy(g)))
    loss, got = out["layer"]
    assert abs(loss / float(jloss) - 1) <= LOSS_REL
    want = flatten_paths(jax.tree_util.tree_map(np.asarray, jg))
    assert set(got) == set(want)
    for name in want:
        assert _rel(got[name], want[name]) <= GRAD_REL, name
        assert _rel(out["none"][1][name], got[name]) <= 1e-6, name
    assert any(np.abs(want[n]).max() > 0 for n in want if n.endswith("/A"))


def test_smoke_train_steps_match_reference():
    """Three make_train_step steps of falcon-mamba SMOKE against the
    reference's train step from the same bridged state (kernel route:
    scan_fn, whose plain versions run here): losses 1e-5 relative, the
    adapters after each step within 1e-4 of max."""
    jm, tm, params, adapters = _smoke_state()
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=STEPS, eps=1e-4)
    jstep = jax.jit(j_make_train_step(
        jm, JStep(dora=JConfig(rank=RANK, alpha=ALPHA, mode="eager"),
                  optim=JOpt(**ocfg)), None, batch=BATCH, seq=SEQ))
    tstep = tsteps.make_train_step(
        tm, tsteps.StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA,
                                              mode="fused"),
                              optim=OptimizerConfig(**ocfg)),
        batch=BATCH, seq=SEQ)
    jopt = jax.tree_util.tree_map(
        np.array, build_state(jm, JConfig(rank=RANK, alpha=ALPHA), 0)[2])
    jp, ja, jo = (jax.tree_util.tree_map(jnp.asarray, t)
                  for t in (params, adapters, jopt))
    # Copies: the port's step updates its adapters in place, and a tensor
    # from tree_from_numpy shares memory with its numpy array, which
    # jnp.asarray may alias in turn on the CPU (the reference's inputs).
    tp, ta = (tree_from_numpy(jax.tree_util.tree_map(np.array, t))
              for t in (params, adapters))
    to = adamw_init(ta)
    tkernels.reset_launch_counts()
    for batch in _batches():
        ja, jo, jmet = jstep(jp, ja, jo, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        ta, to, tmet = tstep(tp, ta, to, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
        assert abs(float(tmet["loss"]) / float(jmet["loss"]) - 1) <= LOSS_REL
        got = flatten_paths(tree_to_numpy(ta))
        want = flatten_paths(jax.tree_util.tree_map(np.asarray, ja))
        for name in want:
            assert _rel(got[name], want[name]) <= GRAD_REL, name
    assert sum(tkernels.launch_counts().values()) == 0


def test_train_cli_trains_falcon_mamba_smoke_on_cpu(capsys):
    ttrain.main(["--arch", "falcon-mamba-7b", "--smoke", "--device", "cpu",
                 "--steps", "2", "--batch", "2", "--seq", "24",
                 "--log-every", "1"])
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "done: 2 steps" in out
