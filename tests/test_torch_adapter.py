"""The port's DoRA adapter against the reference, on bridged weights.

Weights and activations are made with numpy, bridged into both packages,
and run through ``dora_linear`` / ``precompute_adapter_state``: the
reference in interpret mode (its Pallas kernels) or eager, the port in
fused mode (its kernels' plain versions on CPU tensors) or eager. fp32
outputs agree within 1e-5 of the reference's largest magnitude.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adapter as jadapter
from repro.core.config import DoRAConfig as JConfig
from repro_torch import kernels as tkernels
from repro_torch.bridge import tree_from_numpy
from repro_torch.core import adapter as tadapter
from repro_torch.core.config import FORCE_TIER_ENV, DoRAConfig
from repro_torch.kernels import dora_compose, factored_norm, norm_assembly


@pytest.fixture(autouse=True)
def _no_forced_tier(monkeypatch):
    for name in ("REPRO_FORCE_TIER", "REPRO_DORA_MODE", "REPRO_DORA_FUSED",
                 FORCE_TIER_ENV):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture
def plain_calls(monkeypatch):
    """Count the kernels' plain versions as the wrappers reach them."""
    calls = {}

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    counting(factored_norm, "norm_terms_plain")
    counting(norm_assembly, "assemble_norm_plain")
    counting(dora_compose, "compose_fwd_plain")
    counting(dora_compose, "compose_mm_fwd_plain")
    return calls


def _close(got, want, rel=1e-5):
    got = got.detach().double().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, rel)


def _adapter(rng, d_out, d_in, r, stack=()):
    W = (rng.standard_normal(stack + (d_out, d_in))
         / np.sqrt(d_in)).astype(np.float32)
    A = (rng.uniform(-1, 1, stack + (r, d_in)) / np.sqrt(d_in)).astype(
        np.float32)
    B = (0.05 * rng.standard_normal(stack + (d_out, r))).astype(np.float32)
    m = (np.sqrt((W.astype(np.float64) ** 2).sum(-1))
         * (1 + 0.01 * rng.standard_normal(stack + (d_out,)))).astype(
        np.float32)
    return W, {"A": A, "B": B, "m": m}


def _jtree(tree):
    return {k: _jtree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("rows_shape,route", [((2, 32), "compose_mm_fwd"),
                                              ((2, 1), "compose_fwd")])
@pytest.mark.parametrize("cached", [False, True])
def test_dora_linear_kernel_route_matches_reference(rows_shape, route,
                                                    cached, plain_calls):
    """Prefill-shaped rows take the matmul-fused compose (K6), decode rows
    the materialized one (K3); uncached trees also run K1/K2."""
    rng = np.random.default_rng(0)
    W, ad = _adapter(rng, 256, 128, 16)
    x = rng.standard_normal(rows_shape + (128,)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(256)).astype(np.float32)
    jcfg, tcfg = (JConfig(rank=16, alpha=32.0, mode="interpret"),
                  DoRAConfig(rank=16, alpha=32.0, mode="fused"))
    jad, tad = _jtree(ad), tree_from_numpy(ad)
    if cached:
        jad = jadapter.precompute_adapter_state(
            {"w": jnp.asarray(W)}, {"w": jad}, jcfg)["w"]
        tad = tadapter.precompute_adapter_state(
            {"w": torch.from_numpy(W)}, {"w": tad}, tcfg)["w"]
        _close(tad["g"], jad["g"])
    want = jadapter.dora_linear(jnp.asarray(x), jnp.asarray(W), jad, jcfg,
                                bias=jnp.asarray(bias), training=False)
    got = tadapter.dora_linear(torch.from_numpy(x), torch.from_numpy(W), tad,
                               tcfg, bias=torch.from_numpy(bias),
                               training=False)
    _close(got, want)
    # K1/K2 run once either way: in the precompute or in the layer.
    assert plain_calls == {route + "_plain": 1, "norm_terms_plain": 1,
                           "assemble_norm_plain": 1}
    assert tkernels.launch_counts() == dict.fromkeys(tkernels.KERNELS, 0)


@pytest.mark.parametrize("fold", [False, True])
def test_dora_linear_eager_and_gsb_match_reference(fold):
    rng = np.random.default_rng(1)
    W, ad = _adapter(rng, 200, 96, 8)          # d_out % 128 != 0: eager
    x = rng.standard_normal((3, 4, 96)).astype(np.float32)
    jcfg, tcfg = JConfig(rank=8, alpha=8.0), DoRAConfig(rank=8, alpha=8.0)
    jad = jadapter.precompute_adapter_state(
        {"w": jnp.asarray(W)}, {"w": _jtree(ad)}, jcfg, fold_gsb=fold)["w"]
    tad = tadapter.precompute_adapter_state(
        {"w": torch.from_numpy(W)}, {"w": tree_from_numpy(ad)}, tcfg,
        fold_gsb=fold)["w"]
    assert ("gsB" in tad) == fold
    if fold:
        _close(tad["gsB"], jad["gsB"])
    want = jadapter.dora_linear(jnp.asarray(x), jnp.asarray(W), jad, jcfg,
                                training=False)
    got = tadapter.dora_linear(torch.from_numpy(x), torch.from_numpy(W), tad,
                               tcfg, training=False)
    _close(got, want)
    raw = tadapter.invalidate_adapter_state({"w": tad})["w"]
    assert set(raw) == {"A", "B", "m"}


def test_precompute_stacked_matches_reference_and_base_sq_cache():
    rng = np.random.default_rng(2)
    W, ad = _adapter(rng, 256, 64, 8, stack=(3,))
    base_sq = (W.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    ad["base_sq"] = base_sq
    params = {"stack": {"l0": {"mixer": {"wq": W}}}}
    adapters = {"stack": {"l0": {"mixer": {"wq": ad}}}}
    for mode_j, mode_t in (("interpret", "fused"), ("eager", "eager")):
        jcfg = JConfig(rank=8, alpha=16.0, mode=mode_j)
        tcfg = DoRAConfig(rank=8, alpha=16.0, mode=mode_t)
        want = jadapter.precompute_adapter_state(
            _jtree(params), _jtree(adapters), jcfg, act_dtype=jnp.bfloat16,
            fold_gsb=True)
        got = tadapter.precompute_adapter_state(
            tree_from_numpy(params), tree_from_numpy(adapters), tcfg,
            act_dtype=torch.bfloat16, fold_gsb=True)
        leaf_t = got["stack"]["l0"]["mixer"]["wq"]
        leaf_j = want["stack"]["l0"]["mixer"]["wq"]
        assert set(leaf_t) == set(leaf_j)
        assert leaf_t["g"].shape == (3, 256)
        _close(leaf_t["g"], leaf_j["g"])
        _close(leaf_t["gsB"], leaf_j["gsB"])
        assert torch.equal(leaf_t["A"], torch.from_numpy(ad["A"]))


@pytest.mark.parametrize("impl", ["factored", "dense_ba", "peft_eye"])
def test_compute_weight_norm_impls_match_reference(impl):
    rng = np.random.default_rng(3)
    W, ad = _adapter(rng, 128, 80, 6)
    jw = jadapter.compute_weight_norm(
        jnp.asarray(W), jnp.asarray(ad["A"]), jnp.asarray(ad["B"]),
        JConfig(rank=6, alpha=12.0, norm_impl=impl, mode="eager"))
    tw = tadapter.compute_weight_norm(
        torch.from_numpy(W), torch.from_numpy(ad["A"]),
        torch.from_numpy(ad["B"]),
        DoRAConfig(rank=6, alpha=12.0, norm_impl=impl, mode="fused"))
    _close(tw, jw)


def test_init_dora_params_stacked():
    rng = np.random.default_rng(4)
    W = torch.from_numpy((rng.standard_normal((2, 128, 64)) / 8).astype(
        np.float32))
    gen = torch.Generator().manual_seed(0)
    p = tadapter.init_dora_params(W, DoRAConfig(rank=4, cache_base_norm=True),
                                  generator=gen)
    assert p["A"].shape == (2, 4, 64) and p["B"].shape == (2, 128, 4)
    assert not p["B"].any()
    assert p["A"].abs().max() <= 64 ** -0.5
    torch.testing.assert_close(p["m"], W.norm(dim=-1))
    torch.testing.assert_close(p["base_sq"], (W * W).sum(-1))
    # At init (B = 0) the adapted layer is the base layer: g = 1.
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    y = tadapter.dora_linear(x, W[0], {k: v[0] for k, v in p.items()},
                             DoRAConfig(rank=4), training=False)
    torch.testing.assert_close(y, x @ W[0].T, rtol=1e-5, atol=1e-5)


def test_training_is_refused_until_the_training_slice():
    """The training slice is here: training=True runs on the raw adapter
    tree (eager and kernel routes) with gradients to A, B and m, and only
    a tree carrying serving state ("g") is still refused."""
    rng = np.random.default_rng(5)
    W, ad = _adapter(rng, 128, 32, 4)
    x = torch.from_numpy(rng.standard_normal((2, 32)).astype(np.float32))
    for cfg in (DoRAConfig(rank=4), DoRAConfig(rank=4, mode="fused")):
        tad = {k: v.requires_grad_(True)
               for k, v in tree_from_numpy(ad).items()}
        tadapter.dora_linear(x, torch.from_numpy(W), tad, cfg,
                             training=True).square().sum().backward()
        assert all(tad[k].grad is not None for k in ("A", "B", "m"))
    cfg = DoRAConfig(rank=4)
    state = tadapter.precompute_adapter_state(
        {"w": torch.from_numpy(W)}, {"w": tree_from_numpy(ad)}, cfg)["w"]
    with pytest.raises(ValueError, match="precomputed serving state"):
        tadapter.dora_linear(x, torch.from_numpy(W), state, cfg,
                             training=True)
    g = torch.ones(128, requires_grad=True)
    tadapter.compose_delta(torch.ones(2, 128), torch.ones(2, 128), g,
                           DoRAConfig(rank=4, mode="fused"),
                           training=True).sum().backward()
    assert g.grad is not None
