"""The port's core numerics, config and dispatch against the reference.

Inputs are made from a seed with numpy and fed to both packages; fp32
results are compared within 1e-5 of the reference's largest magnitude
(the two frameworks sum in different orders), fp64 oracles within 1e-12.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compose as jcompose
from repro.core import dispatch as jdispatch
from repro.core import factored_norm as jnorm
from repro.core.config import DoRAConfig as JConfig
from repro.kernels import ref as jref
from repro_torch.bridge import tensor_from_numpy as T
from repro_torch.core import compose as tcompose
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import factored_norm as tnorm
from repro_torch.core.config import (FORCE_TIER_ENV, DoRAConfig,
                                     shrink_block_rows)
from repro_torch.kernels import ref as tref

_REF_ENV = ("REPRO_FORCE_TIER", "REPRO_DORA_MODE", "REPRO_DORA_FUSED",
            "REPRO_DORA_NORM_CHUNK_MB")


@pytest.fixture
def clean_env(monkeypatch):
    for name in _REF_ENV + (FORCE_TIER_ENV,):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _close(got, want, rel=1e-5):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, rel)


def _inputs(seed, d_out=96, d_in=200, r=12):
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((d_out, d_in)) / np.sqrt(d_in)).astype(
        np.float32)
    A = (rng.uniform(-1, 1, (r, d_in)) / np.sqrt(d_in)).astype(np.float32)
    B = (0.1 * rng.standard_normal((d_out, r))).astype(np.float32)
    return W, A, B


# --- config -----------------------------------------------------------------

def test_config_fields_and_scaling_match_reference():
    import dataclasses
    ours = {f.name for f in dataclasses.fields(DoRAConfig)}
    theirs = {f.name for f in dataclasses.fields(JConfig)}
    assert ours == theirs
    for rank, alpha, rs in [(384, 192.0, True), (16, 32.0, False),
                            (7, 3.0, True)]:
        assert DoRAConfig(rank=rank, alpha=alpha, rslora=rs).scaling == \
            JConfig(rank=rank, alpha=alpha, rslora=rs).scaling


def test_config_validation():
    with pytest.raises(ValueError, match="no Pallas interpreter"):
        DoRAConfig(mode="interpret")
    with pytest.raises(ValueError, match="unknown mode"):
        DoRAConfig(mode="tpu")
    with pytest.raises(ValueError, match="rank"):
        DoRAConfig(rank=0)
    with pytest.raises(ValueError, match="norm_impl"):
        DoRAConfig(norm_impl="nope")
    with pytest.raises(ValueError, match="mm_block_rows"):
        DoRAConfig(mm_block_rows=0)
    with pytest.raises(NotImplementedError, match="dropout"):
        DoRAConfig(dropout=0.1)
    with pytest.raises(ValueError, match="refused"):
        DoRAConfig(force_tier="interpret")
    assert DoRAConfig(force_tier="cuda").resolve_mode() == "fused"


def test_port_env_override_and_reference_env_ignored(clean_env):
    cfg = DoRAConfig(mode="auto")
    clean_env.setenv("REPRO_FORCE_TIER", "interpret")
    clean_env.setenv("REPRO_DORA_MODE", "eager")
    clean_env.setenv("REPRO_DORA_FUSED", "0")
    assert cfg.resolve_mode() == "auto"
    clean_env.setenv(FORCE_TIER_ENV, "eager")
    assert cfg.resolve_mode() == "eager"
    clean_env.setenv(FORCE_TIER_ENV, "CUDA")
    assert DoRAConfig(force_tier="eager").resolve_mode() == "fused"
    clean_env.setenv(FORCE_TIER_ENV, "interpret")
    with pytest.raises(ValueError, match="no Pallas interpreter"):
        cfg.resolve_mode()
    clean_env.setenv(FORCE_TIER_ENV, "bogus")
    with pytest.raises(ValueError, match=FORCE_TIER_ENV):
        cfg.resolve_mode()


@pytest.mark.parametrize("rows", [None, 1, 4, 8, 9, 64, 100, 255, 256, 4096])
def test_block_rules_match_reference(rows):
    from repro.core.config import shrink_block_rows as jshrink
    for bm in (64, 256):
        assert shrink_block_rows(bm, rows) == jshrink(bm, rows)
    for kw in ({}, {"mm_block_rows": 128}, {"mm_fused_max_rank": 100},
               {"block_rows": 512}):
        t, j = DoRAConfig(**kw), JConfig(**kw)
        assert t.resolve_mm_block_rows(rows) == j.resolve_mm_block_rows(rows)
        assert (t.resolve_mm_fused_max_rank(rows)
                == j.resolve_mm_fused_max_rank(rows))


# --- factored norm ----------------------------------------------------------

def test_dtype_eps_and_chunk_size_match_reference():
    for td, jd in ((torch.bfloat16, jnp.bfloat16), (torch.float16,
                                                    jnp.float16),
                   (torch.float32, jnp.float32)):
        assert tnorm.dtype_eps(td) == jnorm.dtype_eps(jd)
    for args in [(18944, 3584, 256), (512, 3584, 256), (96, 200, None),
                 (96, 200, 1), (4096, 100, 1)]:
        assert tnorm.chunk_size(*args) == jnorm.chunk_size(*args)


@pytest.mark.parametrize("chunk_mb", [None, 1])
def test_factored_norm_terms_match_reference(chunk_mb):
    W, A, B = _inputs(0, d_out=2048, d_in=300)  # chunk_mb=1: 128-col chunks
    got = tnorm.factored_norm_terms(T(W), T(A), T(B), chunk_mb=chunk_mb)
    want = jnorm.factored_norm_terms(jnp.asarray(W), jnp.asarray(A),
                                     jnp.asarray(B), chunk_mb=chunk_mb)
    for g, w in zip(got, want):
        _close(g, w)
    got0 = tnorm.factored_norm_terms(T(W), T(A), T(B), chunk_mb=chunk_mb,
                                     compute_cross=False)
    want0 = jnorm.factored_norm_terms(jnp.asarray(W), jnp.asarray(A),
                                      jnp.asarray(B), chunk_mb=chunk_mb,
                                      compute_cross=False)
    _close(got0[0], want0[0])
    assert not got0[1].any() and not got0[2].any()


@pytest.mark.parametrize("s", [0.0, 0.5, 9.797958971132712])
def test_norms_match_reference(s):
    W, A, B = _inputs(1)
    jW, jA, jB = map(jnp.asarray, (W, A, B))
    tW, tA, tB = map(T, (W, A, B))
    _close(tnorm.factored_norm(tW, tA, tB, s),
           jnorm.factored_norm(jW, jA, jB, s))
    base_sq = (W.astype(np.float64) ** 2).sum(1).astype(np.float32)
    _close(tnorm.factored_norm(tW, tA, tB, s, base_sq_cache=T(base_sq)),
           jnorm.factored_norm(jW, jA, jB, s,
                               base_sq_cache=jnp.asarray(base_sq)))
    for name in ("norm_dense_ba", "norm_peft_eye"):
        _close(getattr(tnorm, name)(tW, tA, tB, s),
               getattr(jnorm, name)(jW, jA, jB, s))
    fp64 = tnorm.norm_reference_fp64(tW, tA, tB, s)
    assert fp64.dtype == torch.float64
    ref64 = np.sqrt(((W.astype(np.float64) + s * (B.astype(np.float64)
                                                  @ A.astype(np.float64)))
                     ** 2).sum(1))
    _close(fp64, ref64, 1e-12)
    _close(tnorm.factored_norm(tW, tA, tB, s), ref64, 1e-5)


def test_assemble_norm_order_and_nan():
    base = np.array([1.0, -3.0, np.nan, 2.0], np.float32)
    cross = np.array([0.1, 0.0, 0.0, -0.2], np.float32)
    ba = np.array([0.01, 0.0, 0.0, 0.03], np.float32)
    s = 0.3
    got = tnorm.assemble_norm(T(base), T(cross), T(ba), s).numpy()
    want = np.asarray(jnorm.assemble_norm(*map(jnp.asarray, (base, cross,
                                                              ba)), s))
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[2]) and got[1] == 0.0


# --- compose ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_compose_matches_reference(dtype):
    import ml_dtypes
    rng = np.random.default_rng(2)
    npdt = np.float32 if dtype == "fp32" else ml_dtypes.bfloat16
    base = rng.standard_normal((3, 5, 128)).astype(np.float32).astype(npdt)
    lora = (0.3 * rng.standard_normal((3, 5, 128))).astype(np.float32).astype(
        npdt)
    g = (1 + 0.002 * rng.standard_normal(128)).astype(np.float32)
    s = 1.7
    got = tcompose.compose_stable(T(base), T(lora), T(g), s)
    want = jcompose.compose_stable(*map(jnp.asarray, (base, lora, g)), s)
    assert got.dtype == T(base).dtype
    _close(got.float(), np.asarray(jnp.asarray(want, jnp.float32)),
           1e-6 if dtype == "fp32" else 2.0 ** -8)
    _close(tcompose.compose_reference_fp64(T(base), T(lora), T(g), s),
           (g.astype(np.float64) - 1) * base.astype(np.float64)
           + g.astype(np.float64) * (s * lora.astype(np.float64)), 1e-12)
    m = np.abs(rng.standard_normal(128)).astype(np.float32)
    wn = np.abs(rng.standard_normal(128)).astype(np.float32)
    wn[:3] = 0.0
    for eps in (1e-6, 1e-12):
        np.testing.assert_array_equal(
            tcompose.magnitude_scale(T(m), T(wn), eps).numpy(),
            np.asarray(jcompose.magnitude_scale(jnp.asarray(m),
                                                jnp.asarray(wn), eps)))
    with pytest.raises(ValueError, match="broadcast"):
        tcompose.check_broadcast(T(g[:64]), T(base))
    with pytest.raises(ValueError, match="broadcast"):
        tcompose.check_broadcast(T(np.ones((2, 128), np.float32)), T(base))


def test_oracles_match_reference():
    W, A, B = _inputs(3, d_out=128, d_in=64, r=8)
    jW, jA, jB = map(jnp.asarray, (W, A, B))
    for g, w in zip(tref.ref_norm_terms(T(W), T(A), T(B)),
                    jref.ref_norm_terms(jW, jA, jB)):
        _close(g, w)
    _close(tref.ref_norm(T(W), T(A), T(B), 0.7), jref.ref_norm(jW, jA, jB,
                                                                0.7))
    _close(tref.ref_norm_fp64(T(W), T(A), T(B), 0.7),
           tnorm.norm_reference_fp64(T(W), T(A), T(B), 0.7), 1e-12)
    rng = np.random.default_rng(4)
    base = rng.standard_normal((6, 128)).astype(np.float32)
    h = rng.standard_normal((6, 8)).astype(np.float32)
    Bm = rng.standard_normal((128, 8)).astype(np.float32)
    g = (1 + 0.01 * rng.standard_normal(128)).astype(np.float32)
    _close(tref.ref_compose_mm(T(base), T(h), T(Bm), T(g), 0.9),
           jref.ref_compose_mm(*map(jnp.asarray, (base, h, Bm, g)), 0.9))
    _close(tref.ref_compose_mm_fp64(T(base), T(h), T(Bm), T(g), 0.9),
           tcompose.compose_reference_fp64(
               T(base), T(h).double() @ T(Bm).double().T, T(g), 0.9), 1e-12)
    bs, cr, ba = (np.abs(rng.standard_normal(128)).astype(np.float32)
                  for _ in range(3))
    _close(tref.ref_assemble(T(bs), T(cr), T(ba), 0.4),
           jref.ref_assemble(*map(jnp.asarray, (bs, cr, ba)), 0.4), 1e-6)
    _close(tref.ref_assemble_fp64(T(bs), T(cr), T(ba), 0.4),
           tref.ref_assemble(T(bs), T(cr), T(ba), 0.4), 1e-6)
    _close(tref.ref_compose_fp64(T(base), T(h @ Bm.T), T(g), 0.9),
           tref.ref_compose(T(base), T(h @ Bm.T), T(g), 0.9), 1e-6)


# --- dispatch ---------------------------------------------------------------

_GRID = list(itertools.product(
    ("auto", "fused", "eager"),        # mode
    (1, 4, 8, 64, 512, 4096),         # rows
    (128, 512, 3584, 18944, 200),     # d_out
    (None, 16, 128, 384, 512, 768)))  # rank


def _accelerated_reference(monkeypatch):
    """The reference's plan as it runs on its accelerator: the compiled
    tier available, so auto mode applies the crossover."""
    monkeypatch.setitem(
        jdispatch.DISPATCH_TABLE, "tpu",
        jdispatch.KernelBackend("tpu", fused=True, interpret=False,
                                available=lambda: True))


def test_plan_compose_matches_reference_on_accelerator(clean_env):
    _accelerated_reference(clean_env)
    for mode, rows, d_out, rank in _GRID:
        for training in (False, True):
            want = jdispatch.plan_compose(
                JConfig(mode=mode), training=training, rows=rows,
                d_out=d_out, rank=rank)
            got = tdispatch.plan_compose(
                DoRAConfig(mode=mode), training=training, rows=rows,
                d_out=d_out, rank=rank, device="cuda")
            key = (mode, rows, d_out, rank, training)
            assert got.tier.value == want.tier.value, key
            assert got.matmul_fused == want.matmul_fused, key
            assert got.backend == ("eager" if want.backend == "eager"
                                   else "cuda"), key


def test_plan_on_cpu_tensors_matches_reference_on_cpu_host(clean_env):
    """Auto mode on CPU tensors is eager, as the reference on a CPU host;
    a forced kernel mode keeps the kernel route on both."""
    for mode, rows, d_out, rank in _GRID:
        want = jdispatch.plan_compose(JConfig(mode=mode), training=False,
                                      rows=rows, d_out=d_out, rank=rank)
        got = tdispatch.plan_compose(DoRAConfig(mode=mode), training=False,
                                     rows=rows, d_out=d_out, rank=rank,
                                     device="cpu")
        assert (got.tier.value, got.matmul_fused) == \
            (want.tier.value, want.matmul_fused), (mode, rows, d_out, rank)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_plan_norm_matches_reference(clean_env, device):
    if device == "cuda":
        _accelerated_reference(clean_env)
    for mode in ("auto", "fused", "eager"):
        for d_out in (128, 512, 18944, 200):
            want = jdispatch.plan_norm(JConfig(mode=mode), d_out=d_out)
            got = tdispatch.plan_norm(DoRAConfig(mode=mode), d_out=d_out,
                                      device=device)
            assert got.tier.value == want.tier.value, (mode, d_out, device)
            assert got.fused == want.fused


def test_serving_path_plan_at_qwen2_7b_widths(clean_env):
    """The plan this slice is built around: r=384 at 4 x 1024 prefill rows
    takes the matmul-fused compose on wq/wo/w_gate/w_up/w_down and leaves
    wk/wv (d_out 512) eager; 4-row decode is eager in auto mode and K3 in
    forced mode."""
    auto, fused = DoRAConfig(), DoRAConfig(mode="fused")
    d_outs = {"wq": 3584, "wk": 512, "wv": 512, "wo": 3584,
              "w_gate": 18944, "w_up": 18944, "w_down": 3584}
    prefill = {k: tdispatch.plan_compose(auto, training=False, rows=4096,
                                         d_out=n, rank=384)
               for k, n in d_outs.items()}
    assert {k for k, p in prefill.items() if p.matmul_fused} == \
        {"wq", "wo", "w_gate", "w_up", "w_down"}
    assert all(not p.fused for k, p in prefill.items() if k in ("wk", "wv"))
    for n in d_outs.values():
        assert not tdispatch.plan_compose(auto, training=False, rows=4,
                                          d_out=n, rank=384).fused
        p = tdispatch.plan_compose(fused, training=False, rows=4, d_out=n,
                                   rank=384)
        assert p.tier is tdispatch.Tier.FUSED_FWD and not p.matmul_fused
        assert tdispatch.plan_compose(fused, training=False, rows=4096,
                                      d_out=n, rank=384).matmul_fused
    clean_env.setenv(FORCE_TIER_ENV, "eager")
    assert not tdispatch.plan_norm(auto, d_out=3584).fused
