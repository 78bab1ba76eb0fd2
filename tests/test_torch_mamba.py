"""The port's Mamba-1 serving slice against the reference.

  - K9's plain version (``selective_scan_plain``) against the reference's
    Pallas kernel in interpret mode at the shapes of
    ``tests/test_selective_scan_kernel.py``, against the reference's XLA
    scan ``_ssm_scan_fused`` at a ragged S, and across split calls;
  - ``mamba_block`` against the reference's, with perturbed adapters
    (B != 0, m != ||W||, so g != 1), in its prefill and its one-token
    decode form, for both ``ssm_impl`` values, on the eager route and on
    the forced kernel route (whose wrappers run their plain versions on
    CPU tensors), at d_model 128 so that in_proj and out_proj divide 128;
  - the whole slice: ``generate`` on falcon-mamba SMOKE in fp32 against
    the reference's, and the SSM cache after prefill bridged both ways;
  - the refusals (padded SSM prefill, a scan gradient for A or h0, the
    engine on an SSM stack, hybrid and MoE stacks) and the full config's
    widths; SSM training itself runs (``test_torch_mamba_train.py``).

Every input is made with numpy from a seed and handed to both packages;
every tolerance is scaled to the reference's largest magnitude.
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
from repro.kernels.selective_scan import selective_scan_pallas
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.launch.train import build_state
from repro.models import mamba as jmamba
from repro.models.config import ModelConfig as JModel
from repro_torch import kernels as tkernels
from repro_torch.bridge import (flatten_paths, tree_from_numpy,
                                tree_to_numpy)
from repro_torch.configs import get_config
from repro_torch.core import dispatch
from repro_torch.core.config import FORCE_TIER_ENV, DoRAConfig
from repro_torch.kernels import dora_compose, factored_norm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import selective_scan as tk_scan
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import lm as tlm
from repro_torch.models import mamba as tmamba
from repro_torch.models.config import ModelConfig
from test_torch_archs import assert_spec_matches_reference

RANK, ALPHA = 16, 32.0
REL = 1e-5
BLOCK_WIDTHS = dict(name="mamba-block", family="ssm", num_layers=1,
                    d_model=128, num_heads=0, num_kv_heads=0, d_ff=0,
                    vocab_size=64, ssm=True, ssm_state=16)


@pytest.fixture(autouse=True)
def _no_forced_tier(monkeypatch):
    for name in ("REPRO_FORCE_TIER", "REPRO_DORA_MODE", "REPRO_DORA_FUSED",
                 FORCE_TIER_ENV):
        monkeypatch.delenv(name, raising=False)


def _close(got, want, rel=REL):
    """max |got - want| within ``rel`` of the reference's largest value."""
    got = (got.detach().double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float64))
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"max err {err} > {rel} x {scale}"


# --- K9: the plain version against the reference ---------------------------

def _scan_inputs(seed, B, S, di, n):
    """dt > 0 (softplus of a normal), x, B, C, A < 0 and h0, as numpy fp32
    in the reference's model layout (A [di, n], h0 [B, di, n])."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dt = np.log1p(np.exp(f(B, S, di))).astype(np.float32)
    xi, Bm, Cm = f(B, S, di), f(B, S, n), f(B, S, n)
    A = -np.exp(0.5 * f(di, n)).astype(np.float32)
    h0 = f(B, di, n)
    return dt, (dt * xi).astype(np.float32), Bm, Cm, A, h0


def _kernel_layout(dt, dtx, Bm, Cm, A, h0):
    return (dt, dtx, Bm, Cm, np.ascontiguousarray(A.T),
            np.ascontiguousarray(h0.transpose(0, 2, 1)))


@pytest.mark.parametrize("B,S,di,n,block_di,chunk", [
    (1, 8, 128, 4, 128, 4),
    (2, 16, 256, 16, 128, 8),
    (1, 32, 128, 8, 128, 32),
    (2, 12, 128, 16, 128, 4),
])
def test_scan_plain_matches_pallas(B, S, di, n, block_di, chunk):
    args = _kernel_layout(*_scan_inputs(B * S + n, B, S, di, n))
    want_y, want_h = selective_scan_pallas(*map(jnp.asarray, args),
                                           block_di=block_di, chunk=chunk,
                                           interpret=True)
    tkernels.reset_launch_counts()
    got_y, got_h = tk_scan.selective_scan(*map(torch.from_numpy, args))
    assert tkernels.launch_counts()["selective_scan"] == 0
    assert got_y.dtype == got_h.dtype == torch.float32
    _close(got_y, want_y)
    _close(got_h, want_h)


def test_scan_plain_matches_fused_chunk_at_ragged_s():
    """S = 37 is no multiple of the reference's unroll (8): the reference
    pads, the port's scan takes S as it is."""
    dt, dtx, Bm, Cm, A, h0 = _scan_inputs(5, 2, 37, 128, 16)
    want_y, want_h = jmamba._ssm_scan_fused(
        *map(jnp.asarray, (dt, dtx, Bm, Cm, A, h0)), 8)
    y, h = tmamba.ssm_scan(*map(torch.from_numpy, (dt, dtx, Bm, Cm, A, h0)),
                           DoRAConfig(rank=4, mode="fused"))
    _close(y, want_y)
    _close(h, want_h)


def test_scan_carries_state_across_split_calls():
    args = [torch.from_numpy(a) for a in
            _kernel_layout(*_scan_inputs(6, 2, 21, 128, 16))]
    dt, dtx, Bm, Cm, A_t, h0_t = args
    y_full, h_full = tk_scan.selective_scan(*args)
    y1, h1 = tk_scan.selective_scan(dt[:, :13], dtx[:, :13], Bm[:, :13],
                                    Cm[:, :13], A_t, h0_t)
    y2, h2 = tk_scan.selective_scan(dt[:, 13:], dtx[:, 13:], Bm[:, 13:],
                                    Cm[:, 13:], A_t, h1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y_full)
    assert torch.equal(h2, h_full)
    # an empty sequence returns the state it was given
    y0, h0 = tk_scan.selective_scan(dt[:, :0], dtx[:, :0], Bm[:, :0],
                                    Cm[:, :0], A_t, h0_t)
    assert y0.shape == (2, 0, 128) and torch.equal(h0, h0_t)


def test_scan_wrapper_checks_shapes_and_never_falls_back():
    args = [torch.from_numpy(a) for a in
            _kernel_layout(*_scan_inputs(7, 1, 4, 128, 4))]
    with pytest.raises(ValueError, match="h0_t"):
        tk_scan.selective_scan(*args[:5], args[5][:, :2])
    meta = [torch.empty(a.shape, device="meta") for a in args]
    with pytest.raises(RuntimeError, match="CUDA unavailable"):
        tk_scan.selective_scan(*meta)
    assert tkernels.KERNELS["selective_scan"] is tk_scan.selective_scan
    # K9 ends the TPU table's kernels; the scan's backward, which has no
    # TPU counterpart, follows it.
    assert list(tkernels.KERNELS)[-2:] == ["selective_scan",
                                           "selective_scan_bwd"]


def test_plan_scan():
    auto = DoRAConfig(rank=4)
    assert dispatch.plan_scan(auto, device="cpu").backend == "eager"
    plan = dispatch.plan_scan(auto, device="cuda")
    assert plan.fused and plan.backend == "cuda"
    assert dispatch.plan_scan(None, device="cuda").fused
    assert not dispatch.plan_scan(None, device="cpu").fused
    assert not dispatch.plan_scan(DoRAConfig(rank=4, mode="eager"),
                                  device="cuda").fused
    # a forced kernel mode keeps the kernel route on CPU tensors (whose
    # wrapper runs the plain version there)
    assert dispatch.plan_scan(DoRAConfig(rank=4, mode="fused"),
                              device="cpu").fused


def test_plan_scan_honours_the_eager_override(monkeypatch):
    monkeypatch.setenv(FORCE_TIER_ENV, "eager")
    assert not dispatch.plan_scan(DoRAConfig(rank=4), device="cuda").fused
    assert not dispatch.plan_scan(None, device="cuda").fused


# --- the block --------------------------------------------------------------

def _perturb(adapters, rng):
    """Nonzero B and m = ||W||·(1 + noise), so that g != 1."""
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


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree["stack"]["l0"])


@pytest.mark.parametrize("impl", ["fused_chunk", "assoc"])
@pytest.mark.parametrize("route", ["eager", "fused"])
@pytest.mark.parametrize("decode", [False, True], ids=["prefill", "decode"])
def test_mamba_block_matches_reference(impl, route, decode):
    jm = JModel(**BLOCK_WIDTHS, ssm_impl=impl, dtype=jnp.float32)
    tm = ModelConfig(**BLOCK_WIDTHS, ssm_impl=impl, dtype=torch.float32)
    params, adapters = _np_state(jm, 3)
    p, a = _layer0(params)["mixer"], _layer0(adapters)["mixer"]
    rng = np.random.default_rng(4)
    B, S = 2, 1 if decode else 13
    x = rng.standard_normal((B, S, 128)).astype(np.float32)
    cache = None
    if decode:
        cache = {"h": rng.standard_normal((B, 256, 16)).astype(np.float32),
                 "conv": rng.standard_normal((B, 3, 256)).astype(np.float32)}
    want, want_c = jmamba.mamba_block(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p),
        jax.tree_util.tree_map(jnp.asarray, a), jm,
        JConfig(rank=RANK, alpha=ALPHA,
                mode="interpret" if route == "fused" else "eager"),
        cache=None if cache is None else jax.tree_util.tree_map(
            jnp.asarray, cache), training=False)
    tkernels.reset_launch_counts()
    got, got_c = tmamba.mamba_block(
        torch.from_numpy(x), tree_from_numpy(p), tree_from_numpy(a), tm,
        DoRAConfig(rank=RANK, alpha=ALPHA, mode=route),
        cache=None if cache is None else tree_from_numpy(cache),
        training=False)
    assert sum(tkernels.launch_counts().values()) == 0
    _close(got, want)
    if decode:
        _close(got_c["h"], want_c["h"])
        _close(got_c["conv"], want_c["conv"])   # holds in_proj's new row


def test_mamba_block_routes_through_the_kernel_wrappers(monkeypatch):
    """On the forced kernel route a prefill runs K1/K2 (the norms), K6
    (the compose) and K9 (the scan) through their wrappers, whose plain
    versions run on CPU tensors; the eager route calls none of them."""
    calls: dict = {}
    for mod, name in ((factored_norm, "norm_terms_plain"),
                      (dora_compose, "compose_mm_fwd_plain"),
                      (tk_scan, "selective_scan_plain")):
        fn = getattr(mod, name)

        def wrapped(*args, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, name, wrapped)
    tm = ModelConfig(**BLOCK_WIDTHS, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    dcfg = DoRAConfig(rank=RANK, alpha=ALPHA, mode="fused")
    params = tlm.init_params(gen, tm)
    adapters = tlm.init_adapters(gen, tm, params, dcfg)
    p = {k: v[0] for k, v in params["stack"]["l0"]["mixer"].items()}
    a = {k: {n: t[0] for n, t in v.items()}
         for k, v in adapters["stack"]["l0"]["mixer"].items()}
    # 80 rows: the matmul-fused compose takes r = 16 from 64 rows on
    x = torch.randn(2, 40, 128, generator=gen)
    with torch.no_grad():
        tmamba.mamba_block(x, p, a, tm, dcfg, training=True)
    assert calls == {"norm_terms_plain": 2, "compose_mm_fwd_plain": 2,
                     "selective_scan_plain": 1}
    calls.clear()
    tmamba.mamba_block(x, p, a, tm, dataclasses.replace(dcfg, mode="eager"),
                       training=False)
    assert calls == {}


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    w = rng.standard_normal((4, 32)).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    c = rng.standard_normal((2, 3, 32)).astype(np.float32)
    for cache in (None, c):
        want, want_c = jmamba._causal_conv(
            *map(jnp.asarray, (x, w, b)),
            None if cache is None else jnp.asarray(cache))
        got, got_c = tmamba.causal_conv(
            *map(torch.from_numpy, (x, w, b)),
            None if cache is None else torch.from_numpy(cache))
        _close(got, want)
        _close(got_c, want_c, rel=0)


# --- the whole slice: falcon-mamba SMOKE -----------------------------------

GEN = 4


def _smoke():
    jm = j_get_config("falcon-mamba-7b", smoke=True)
    params, adapters = _np_state(jm, 0)
    return jm, get_config("falcon-mamba-7b", smoke=True), params, adapters


def test_slice_generate_matches_reference(monkeypatch):
    calls: dict = {}
    for mod, name in ((factored_norm, "norm_terms_plain"),
                      (dora_compose, "compose_mm_fwd_plain"),
                      (dora_compose, "compose_fwd_plain"),
                      (tk_scan, "selective_scan_plain")):
        fn = getattr(mod, name)

        def wrapped(*args, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, name, wrapped)
    jm, tm, params, adapters = _smoke()
    prompts = np.random.default_rng(1).integers(0, 256, (2, 37))
    j_tok, j_logits = jserve.generate(
        jm, params, adapters,
        jsteps.StepConfig(dora=JConfig(rank=RANK, alpha=ALPHA,
                                       mode="interpret")),
        prompts, gen_len=GEN, max_len=48, return_logits=True)
    t_tok, t_logits = tserve.generate(
        tm, tree_from_numpy(params), tree_from_numpy(adapters),
        tsteps.StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA,
                                          mode="fused")),
        prompts, gen_len=GEN, max_len=48, return_logits=True, device="cpu")
    # in_proj (d_out 256) takes the kernel route: K1/K2 once per layer in
    # the precompute, K6 in the 74-row prefill, K3 in each 2-row decode
    # step; out_proj (d_out 64, no multiple of 128) stays eager. K9 runs
    # once per layer in the prefill; a one-token decode step takes the
    # one-step update.
    L = tm.num_layers
    assert calls == {"norm_terms_plain": L, "compose_mm_fwd_plain": L,
                     "compose_fwd_plain": L * GEN,
                     "selective_scan_plain": L}
    for step in range(GEN):
        _close(t_logits[step], j_logits[step])
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))


def test_prefill_cache_bridges_both_ways():
    """The SSM cache after prefill equals the reference's; each package's
    cache, bridged to the other, decodes the same next logits."""
    jm, tm, params, adapters = _smoke()
    j_scfg = jsteps.StepConfig(dora=JConfig(rank=RANK, alpha=ALPHA,
                                            mode="eager"))
    t_scfg = tsteps.StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA,
                                               mode="eager"))
    toks = np.random.default_rng(2).integers(0, 256, (2, 11))
    jp, ja = (jax.tree_util.tree_map(jnp.asarray, t)
              for t in (params, adapters))
    tp, ta = tree_from_numpy(params), tree_from_numpy(adapters)
    _, j_cache = jsteps.make_prefill_step(jm, j_scfg, batch=2, seq=16)(
        jp, ja, {"tokens": jnp.asarray(toks, jnp.int32)})
    _, t_cache = tsteps.make_prefill_step(tm, t_scfg, batch=2, seq=16)(
        tp, ta, {"tokens": torch.from_numpy(toks)})
    j_np = jax.tree_util.tree_map(np.asarray, j_cache)
    t_np = tree_to_numpy(t_cache)
    assert set(flatten_paths(t_np)) == set(flatten_paths(j_np)) == {
        "stack/l0/h", "stack/l0/conv", "len"}
    assert t_np["stack"]["l0"]["h"].shape == (2, 2, 128, 4)
    assert int(t_np["len"]) == int(j_np["len"]) == 11
    _close(t_np["stack"]["l0"]["h"], j_np["stack"]["l0"]["h"])
    _close(t_np["stack"]["l0"]["conv"], j_np["stack"]["l0"]["conv"])

    nxt = np.array([[3], [7]])
    j_dec = jsteps.make_decode_step(jm, j_scfg, batch=2)
    t_dec = tsteps.make_decode_step(tm, t_scfg, batch=2)
    want, _ = j_dec(jp, ja, j_cache, {"tokens": jnp.asarray(nxt, jnp.int32)})
    got, t_after = t_dec(tp, ta, tree_from_numpy(j_np),
                         {"tokens": torch.from_numpy(nxt)})
    _close(got, want)
    assert int(t_after["len"]) == 12
    back, _ = j_dec(jp, ja, jax.tree_util.tree_map(jnp.asarray, t_np),
                    {"tokens": jnp.asarray(nxt, jnp.int32)})
    _close(np.asarray(back), want)


def test_cli_serves_falcon_mamba_smoke_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "falcon-mamba-7b", "--smoke", "--device", "cpu",
        "--batch", "2", "--prompt-len", "7", "--gen-len", "3"])
    tserve.main()
    out = capsys.readouterr().out
    assert "generated [2, 10] on cpu" in out and "tok/s" in out


# --- refusals and the config -------------------------------------------------

def test_padded_ssm_prefill_is_refused():
    tm = get_config("falcon-mamba-7b", smoke=True)
    with pytest.raises(ValueError, match="cannot be rewound"):
        tsteps.make_prefill_step(tm, tsteps.StepConfig(), batch=1, seq=8,
                                 padded=True)
    step = tsteps.make_prefill_step(tm, tsteps.StepConfig(), batch=1, seq=8)
    params, adapters = tserve.build_state(tm, DoRAConfig(rank=4), 0, "cpu")
    with pytest.raises(ValueError, match="P <= 8"):
        step(params, adapters, {"tokens": torch.zeros(1, 9,
                                                      dtype=torch.long)})


def test_ssm_training_is_refused():
    """SSM training runs now (the scan's backward, test_torch_mamba_train.py
    holds it against jax.grad); what stays refused is a gradient for the
    scan's A or h0, which the reference stops too."""
    tm = get_config("falcon-mamba-7b", smoke=True)
    dcfg = DoRAConfig(rank=4, mode="fused")
    params, adapters = tserve.build_state(tm, dcfg, 0, "cpu")
    step = tsteps.make_grad_step(tm, tsteps.StepConfig(dora=dcfg), batch=1,
                                 seq=4)
    toks = torch.zeros(1, 4, dtype=torch.long)
    loss, grads = step(params, adapters, {"tokens": toks, "labels": toks})
    assert torch.isfinite(loss)
    g = flatten_paths(grads)
    assert set(g) == set(flatten_paths(adapters))
    # a fresh DoRA init has B = 0: B is the leaf whose gradient moves first
    assert all(v.abs().max() > 0 for k, v in g.items() if k.endswith("/B"))
    args = [torch.ones(1, 4, 8) for _ in range(2)] + [
        torch.ones(1, 4, 2) for _ in range(2)]
    with pytest.raises(ValueError, match="stop_gradient"):
        tops.scan_fn(*args, -torch.ones(2, 8, requires_grad=True),
                     torch.zeros(1, 2, 8))


def test_engine_refuses_ssm_stacks():
    tm = get_config("falcon-mamba-7b", smoke=True)
    params, _ = tserve.build_state(tm, DoRAConfig(rank=4), 0, "cpu")
    with pytest.raises(NotImplementedError, match="attention-only"):
        DecodeEngine(tm, tsteps.StepConfig(), params, slots=2, max_len=16,
                     device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        tlm.cache_shapes(tm, 2, 16, row_lens=True, block_size=8)


@pytest.mark.parametrize("flags,match", [
    ({"attn_period": 8}, "hybrid"),
    ({"moe": True, "moe_period": 2}, "MoE"),
])
def test_hybrid_and_moe_stacks_are_refused(flags, match):
    """A Mamba stack with attention every 8th layer (hybrid) or MoE on
    every 2nd layer builds as the reference's does: a unit of ``period``
    layers whose spec equals the reference's leaf by leaf. Refused, as
    before: a depth that is no whole number of units (ValueError naming
    the stack's kind, where the reference's ``period`` asserts) and an
    unknown ``ssm_impl``."""
    hybrid = "attn_period" in flags
    extra = (dict(num_heads=2, num_kv_heads=1) if hybrid
             else dict(num_experts=4, top_k=2, moe_d_ff=64))
    widths = {**BLOCK_WIDTHS, "num_layers": 8, **extra}
    tm = ModelConfig(**widths, **flags)
    jm = JModel(**widths, **flags)
    assert tm.period == jm.period == (8 if hybrid else 2)
    assert tm.n_scan == 8 // tm.period
    assert_spec_matches_reference(tm, jm)
    depth = 12 if hybrid else 9
    with pytest.raises(ValueError, match=f"a {match}"):
        tlm.model_spec(dataclasses.replace(tm, num_layers=depth))
    with pytest.raises(AssertionError):
        dataclasses.replace(jm, num_layers=depth).period
    with pytest.raises(ValueError, match="ssm_impl"):
        tlm.model_spec(ModelConfig(**BLOCK_WIDTHS, ssm_impl="scan"))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_matches_reference_widths(smoke):
    t = get_config("falcon-mamba-7b", smoke=smoke)
    j = j_get_config("falcon-mamba-7b", smoke=smoke)
    for f in ("num_layers", "d_model", "d_ff", "vocab_size", "ssm",
              "ssm_state", "ssm_conv", "ssm_expand", "dt_rank", "ssm_chunk",
              "ssm_impl", "ssm_unroll", "attn_period", "moe", "norm_eps",
              "d_inner", "period"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.layer_kinds() == j.layer_kinds()
    assert t.ffn_kinds() == j.ffn_kinds()
    assert t.dtype == (torch.float32 if smoke else torch.bfloat16)
    # the parameter count by the reference's formula, leaf by leaf
    spec = tlm.model_spec(t)
    total = sum(int(np.prod(shape)) * (t.n_scan if path[0] == "stack" else 1)
                for path, (_, shape) in tlm._spec_items(spec))
    assert total == j.count_params()
    if not smoke:
        assert total == 7_272_665_088
        paths = tlm._adapted_paths(t, tlm.DEFAULT_DORA_TARGETS)
        assert [(p[-1], s) for p, s in paths] == [
            ("in_proj", (16384, 4096)), ("out_proj", (4096, 8192))]
        shapes = tlm.cache_shapes(t, 4, 992)
        assert shapes["stack"]["l0"]["h"] == ((64, 4, 8192, 16),
                                              torch.float32)


def test_mamba_init_follows_the_reference_distributions():
    tm = get_config("falcon-mamba-7b", smoke=True)
    params = tlm.init_params(torch.Generator().manual_seed(0), tm)
    p = params["stack"]["l0"]["mixer"]
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)
    assert torch.equal(p["A_log"][0, 5],
                       torch.log(torch.arange(1.0, tm.ssm_state + 1)))
    assert p["conv_w"].abs().max() <= 0.5 and p["conv_w"].std() > 0.1
    assert torch.equal(p["skip_d"], torch.ones_like(p["skip_d"]))
    assert torch.equal(p["conv_b"], torch.zeros_like(p["conv_b"]))
