"""``repro_torch.models.moe`` against ``repro.models.moe``: the router,
the capacity dispatch, the routed and shared experts, the chunk fold, the
gradients, and ``dora_linear_stacked`` against the reference's.

Inputs and weights come from numpy and a seed; both packages run on the
CPU. Forward results must be within 1e-6 of the largest magnitude of the
reference's, gradients within 1e-5. A routing decision is discrete: an ulp
of difference in a router logit could swap the k-th and (k+1)-th expert
(or two chosen experts' order, and with it which assignments drop) and
move an output row by O(1). Each comparison therefore first asserts that
the seeded inputs leave every gap between neighbours of a token's k + 1
largest probabilities far above fp32 rounding, so a flip can only be a
fault of the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adapter as jadapter
from repro.core.config import DoRAConfig as JConfig
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JModel
from repro_torch.bridge import flatten_paths, tree_from_numpy
from repro_torch.core import adapter as tadapter
from repro_torch.core.config import FORCE_TIER_ENV, DoRAConfig
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map

WIDTHS = dict(name="moe-test", family="moe", num_layers=2, d_model=32,
              num_heads=4, num_kv_heads=4, d_ff=16, vocab_size=64,
              moe=True, num_experts=6, top_k=2, moe_d_ff=16,
              capacity_factor=8.0)
SHARED = dict(num_shared_experts=2, shared_d_ff=24)
RANK, ALPHA = 4, 8.0
MARGIN = 1e-4          # least gap between neighbouring top probabilities


@pytest.fixture(autouse=True)
def _no_forced_tier(monkeypatch):
    for name in ("REPRO_FORCE_TIER", "REPRO_DORA_MODE", "REPRO_DORA_FUSED",
                 FORCE_TIER_ENV):
        monkeypatch.delenv(name, raising=False)


def configs(**over):
    kw = {**WIDTHS, **over}
    return (JModel(**kw, dtype=jnp.float32),
            ModelConfig(**kw, dtype=torch.float32))


def _rel(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.detach().double().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def moe_params(seed, mcfg, *, shared=False, shared_gate=True):
    rng = np.random.default_rng(seed)
    D, E, F = mcfg.d_model, mcfg.num_experts, mcfg.moe_d_ff

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(
            np.float32)
    p = {"router": w(E, D), "gate": w(E, F, D), "up": w(E, F, D),
         "down": w(E, D, F)}
    if shared:
        ff = mcfg.shared_d_ff
        p["shared"] = {"w_gate": w(ff, D), "w_up": w(ff, D),
                       "w_down": w(D, ff)}
        if shared_gate:
            p["shared_gate"] = w(1, D)
    return p


def dora_leaf(rng, d_out, d_in, stack=()):
    """A DoRA adapter with B and m off their init, so every term counts."""
    shape = lambda *s: stack + s                                  # noqa: E731
    return {"A": (rng.uniform(-1, 1, shape(RANK, d_in)) / np.sqrt(d_in))
            .astype(np.float32),
            "B": (0.05 * rng.standard_normal(shape(d_out, RANK)))
            .astype(np.float32),
            "m": (1 + 0.05 * rng.standard_normal(shape(d_out)))
            .astype(np.float32)}


def tokens(seed, mcfg, batch=2, seq=12):
    return np.random.default_rng(seed).standard_normal(
        (batch, seq, mcfg.d_model)).astype(np.float32)


def assert_margin(x, router, k):
    """The seeded inputs route with a clear gap between neighbours of each
    token's k + 1 largest probabilities, so no expert or order flips."""
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(router).T,
                          dim=-1)
    top = torch.topk(probs, min(k + 1, probs.shape[-1]), dim=-1).values
    margin = float((top[..., :-1] - top[..., 1:]).min())
    assert margin >= MARGIN, margin


def both(fn_j, fn_t, x, p, dora=None):
    """Run the reference on jnp arrays and the port on tensors."""
    jd = None if dora is None else jax.tree_util.tree_map(jnp.asarray, dora)
    td = None if dora is None else tree_from_numpy(dora)
    return (fn_j(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p),
                 jd),
            fn_t(torch.from_numpy(x), tree_from_numpy(p), td))


# --- the router and the dispatch ---------------------------------------------

@pytest.mark.parametrize("renorm,aux_coef", [(True, 0.0), (False, 0.0),
                                             (True, 0.01), (False, 0.02)])
def test_router_topk_matches_reference(renorm, aux_coef):
    jm, tm = configs(renorm_topk=renorm, router_aux_coef=aux_coef)
    p = moe_params(0, tm)
    x = tokens(1, tm, seq=16)
    assert_margin(x, p["router"], tm.top_k)
    jw, ji, jaux = jmoe.router_topk(jnp.asarray(x), jnp.asarray(p["router"]),
                                    jm)
    tw, ti, taux = tmoe.router_topk(torch.from_numpy(x),
                                    torch.from_numpy(p["router"]), tm)
    assert tw.dtype == torch.float32 and tuple(tw.shape) == (2, 16, 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert _rel(tw, jw) <= 1e-6
    if aux_coef:
        assert float(jaux) > 0
        assert abs(float(taux) / float(jaux) - 1) <= 1e-6
    else:
        assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("capacity", [1, 3, 5, 64])
def test_dispatch_indices_are_exact(capacity):
    """Slots and keep masks equal, overflow included: with 40 assignments
    over 4 experts a capacity of 1, 3 or 5 drops most of them."""
    gate_i = np.random.default_rng(capacity).integers(
        0, 4, (3, 10, 4)).astype(np.int32)
    js, jk = jmoe._dispatch_indices(jnp.asarray(gate_i), 4, capacity)
    ts, tk = tmoe._dispatch_indices(torch.from_numpy(gate_i).long(), 4,
                                    capacity)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert (capacity == 64) == bool(tk.all())


# --- the layer ---------------------------------------------------------------

SETTINGS = {"ample": {}, "drops": {"capacity_factor": 0.5},
            "chunks": {"moe_seq_chunks": 4}}


@pytest.mark.parametrize("setting", SETTINGS)
def test_moe_ffn_matches_reference(setting):
    """Ample capacity, a capacity that drops (the same assignments
    dropped), and the sequence folded into 4 dispatch groups."""
    jm, tm = configs(**SETTINGS[setting], **SHARED)
    p = moe_params(2, tm, shared=True)
    x = tokens(3, tm, seq=16)
    assert_margin(x, p["router"], tm.top_k)
    (jy, jaux), (ty, taux) = both(
        lambda x, p, d: jmoe.moe_ffn(x, p, d, jm, None, training=False),
        lambda x, p, d: tmoe.moe_ffn(x, p, d, tm, None, training=False),
        x, p)
    assert ty.dtype == torch.float32
    assert _rel(ty, jy) <= 1e-6
    assert float(taux) == float(jaux)
    if setting == "drops":
        cap = max(int(tm.capacity_factor * tm.top_k * 16 / tm.num_experts),
                  1)
        _, ji, _ = jmoe.router_topk(jnp.asarray(x), jnp.asarray(p["router"]),
                                    jm)
        _, ti, _ = tmoe.router_topk(torch.from_numpy(x),
                                    torch.from_numpy(p["router"]), tm)
        _, jk = jmoe._dispatch_indices(ji, tm.num_experts, cap)
        _, tk = tmoe._dispatch_indices(ti, tm.num_experts, cap)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        assert 0 < int((~tk).sum()) < tk.numel()


def test_moe_ffn_in_bf16_returns_bf16():
    _, tm = configs(**SHARED)
    tm = dataclasses.replace(tm, dtype=torch.bfloat16)
    p = tree_map(lambda t: t.to(torch.bfloat16),
                 tree_from_numpy(moe_params(4, tm, shared=True)))
    x = torch.from_numpy(tokens(5, tm)).to(torch.bfloat16)
    y, aux = tmoe.moe_ffn(x, p, None, tm, None, training=False)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert aux.dtype == torch.float32
    assert torch.isfinite(y.float()).all()


@pytest.mark.parametrize("shared_gate", [True, False],
                         ids=["sigmoid_gate", "no_gate"])
def test_shared_expert_with_its_adapters(shared_gate):
    """The shared expert through mlp_swiglu with DoRA on its three
    projections, behind the fp32 sigmoid gate or added as it is."""
    jm, tm = configs(**SHARED)
    p = moe_params(6, tm, shared=True, shared_gate=shared_gate)
    rng = np.random.default_rng(7)
    ff, D = tm.shared_d_ff, tm.d_model
    dora = {"shared": {"w_gate": dora_leaf(rng, ff, D),
                       "w_up": dora_leaf(rng, ff, D),
                       "w_down": dora_leaf(rng, D, ff)}}
    jd, td = JConfig(rank=RANK, alpha=ALPHA), DoRAConfig(rank=RANK,
                                                        alpha=ALPHA)
    x = tokens(8, tm)
    assert_margin(x, p["router"], tm.top_k)
    (jy, _), (ty, _) = both(
        lambda x, p, d: jmoe.moe_ffn(x, p, d, jm, jd, training=True),
        lambda x, p, d: tmoe.moe_ffn(x, p, d, tm, td, training=True),
        x, p, dora)
    assert _rel(ty, jy) <= 1e-6


def test_moe_ffn_grads_match_jax_grad():
    """d/dx and d/d(shared adapters) of a scalar of the output, through the
    router's gate weights, the dispatch, the experts and the shared
    expert, within 1e-5 of max against jax.grad; the router and shared
    gate weights get none."""
    jm, tm = configs(**SHARED, capacity_factor=1.0)
    p = moe_params(9, tm, shared=True)
    rng = np.random.default_rng(10)
    ff, D = tm.shared_d_ff, tm.d_model
    dora = {"shared": {"w_gate": dora_leaf(rng, ff, D),
                       "w_up": dora_leaf(rng, ff, D),
                       "w_down": dora_leaf(rng, D, ff)}}
    x = tokens(11, tm)
    assert_margin(x, p["router"], tm.top_k)
    probe = np.random.default_rng(12).standard_normal(x.shape).astype(
        np.float32)
    jd, td = JConfig(rank=RANK, alpha=ALPHA), DoRAConfig(rank=RANK,
                                                        alpha=ALPHA)
    jp = jax.tree_util.tree_map(jnp.asarray, p)

    def jloss(xx, d):
        y, _ = jmoe.moe_ffn(xx, jp, d, jm, jd, training=True)
        return jnp.sum(y * probe)
    jgx, jgd = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, dora))

    tp = tree_from_numpy(p)
    tx = torch.from_numpy(x).requires_grad_(True)
    tdora = tree_from_numpy(dora)
    leaves = flatten_paths(tdora)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    y, _ = tmoe.moe_ffn(tx, tp, tdora, tm, td, training=True)
    (y * torch.from_numpy(probe)).sum().backward()
    assert _rel(tx.grad, jgx) <= 1e-5
    want = flatten_paths(jax.tree_util.tree_map(np.asarray, jgd))
    for name, leaf in leaves.items():
        assert _rel(leaf.grad, want[name]) <= 1e-5, name
    assert all(t.grad is None for t in flatten_paths(tp).values())


# --- DoRA on the routed experts ---------------------------------------------

@pytest.mark.parametrize("training", [True, False], ids=["train", "serve"])
def test_dora_on_experts_matches_reference(training):
    """A hand-built stacked adapter tree on the experts' gate, up and down
    (the reference's vmapped maybe_dora), with one projection left
    unadapted."""
    jm, tm = configs()
    p = moe_params(13, tm)
    rng = np.random.default_rng(14)
    E, F, D = tm.num_experts, tm.moe_d_ff, tm.d_model
    dora = {"experts": {"gate": dora_leaf(rng, F, D, (E,)),
                        "down": dora_leaf(rng, D, F, (E,))}}
    jd, td = JConfig(rank=RANK, alpha=ALPHA), DoRAConfig(rank=RANK,
                                                        alpha=ALPHA)
    x = tokens(15, tm)
    assert_margin(x, p["router"], tm.top_k)
    (jy, _), (ty, _) = both(
        lambda x, p, d: jmoe.moe_ffn(x, p, d, jm, jd, training=training),
        lambda x, p, d: tmoe.moe_ffn(x, p, d, tm, td, training=training),
        x, p, dora)
    assert _rel(ty, jy) <= 1e-6


@pytest.mark.parametrize("extras", ["plain", "bias_and_base_sq"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "serve"])
def test_dora_linear_stacked_matches_reference(training, extras):
    rng = np.random.default_rng(16)
    E, d_out, d_in = 3, 20, 12
    W = (rng.standard_normal((E, d_out, d_in)) / np.sqrt(d_in)).astype(
        np.float32)
    ad = dora_leaf(rng, d_out, d_in, (E,))
    x = rng.standard_normal((E, 5, d_in)).astype(np.float32)
    kw = {}
    if extras != "plain":
        kw = {"bias": (0.1 * rng.standard_normal((E, d_out))).astype(
                  np.float32),
              "base_sq_cache": (W.astype(np.float64) ** 2).sum(-1).astype(
                  np.float32)}
    want = jadapter.dora_linear_stacked(
        jnp.asarray(x), jnp.asarray(W), jax.tree_util.tree_map(jnp.asarray,
                                                               ad),
        JConfig(rank=RANK, alpha=ALPHA), training=training,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tadapter.dora_linear_stacked(
        torch.from_numpy(x), torch.from_numpy(W), tree_from_numpy(ad),
        DoRAConfig(rank=RANK, alpha=ALPHA), training=training,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert _rel(got, want) <= 1e-6


def test_precompute_walk_cannot_reach_expert_adapters():
    """Both packages' ``precompute_adapter_state`` walk the adapter tree
    down the params tree, and an MoE layer's params hold the experts as
    "gate"/"up"/"down" with no "experts" key: an adapter tree with
    experts' adapters is refused with a KeyError by the reference (and by
    the port, which keeps its semantics). Only the shared expert's
    adapters, which the LM adapts, reach a serving state."""
    _, tm = configs()
    p = moe_params(17, tm)
    rng = np.random.default_rng(18)
    E, F, D = tm.num_experts, tm.moe_d_ff, tm.d_model
    dora = {"experts": {"gate": dora_leaf(rng, F, D, (E,))}}
    with pytest.raises(KeyError, match="experts"):
        jadapter.precompute_adapter_state(
            jax.tree_util.tree_map(jnp.asarray, p),
            jax.tree_util.tree_map(jnp.asarray, dora),
            JConfig(rank=RANK, alpha=ALPHA))
    with pytest.raises(KeyError, match="experts"):
        tadapter.precompute_adapter_state(
            tree_from_numpy(p), tree_from_numpy(dora),
            DoRAConfig(rank=RANK, alpha=ALPHA))
