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


def _channel_sum(v):
    """csrc/selective_scan_bwd.cu ``channel_sum`` over one warp, in torch:
    v [32 lanes, 8] (lane 2c + g holds states 8g .. 8g + 7 of channel c),
    the xor reduce-scatter at masks 2, 4, 8, then mask 16 adding the last
    pair. Returns each lane's result [32]."""
    lanes = torch.arange(32)
    for m in (2, 4, 8):
        up = (lanes & m) != 0
        lo, hi = v[:, 0::2], v[:, 1::2]
        send = torch.where(up[:, None], lo, hi)
        v = torch.where(up[:, None], hi, lo) + send[lanes ^ m]
    return v[:, 0] + v[lanes ^ 16, 0]


def test_backward_channel_sum_gives_each_state_one_lane():
    """The backward kernel's sum over a warp's 16 channels leaves state
    (l & 1)·8 + ((l >> 1) & 7) in lane l < 16 (the lane that writes it)
    and the same bits in lane l ^ 16; summed in a fixed tree, within
    fp32 rounding of the plain sum."""
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32))
    v = torch.stack([p[lane // 2, (lane % 2) * 8:(lane % 2) * 8 + 8]
                     for lane in range(32)])
    got = _channel_sum(v)
    for lane in range(16):
        state = (lane & 1) * 8 + ((lane >> 1) & 7)
        assert torch.equal(got[lane], got[lane ^ 16])
        want = p[:, state].double().sum().item()
        assert abs(got[lane].item() - want) <= 1e-5 * p.abs().max().item()
    states = sorted((lane & 1) * 8 + ((lane >> 1) & 7) for lane in range(16))
    assert states == list(range(16))


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
    tp, ta = tree_from_numpy(params), tree_from_numpy(adapters)
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
