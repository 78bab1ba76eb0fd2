"""Multi-tenant serving in the port against the reference: the grouped
gsB-folded compose (static and dynamic), ``select_tenant``, the stacked
serving trees through the bridge, ``MultiTenantServer`` against the
reference's on the same bridged weights, the port's mixed batch against
its own per-tenant ``generate``, and every refusal.

Every tenant here has a nonzero B and m off ||W|| (g != 1): with the DoRA
init (B = 0) every tenant computes the base model, and a row served under
the wrong tenant would pass unnoticed. The tests assert that the
tenants' outputs differ pairwise.

Tolerances (fp32): the port against the reference within 1e-6 of max |y|
for one linear and 1e-5 of max |logit| for the whole model; inside the
port, a group's delta is bitwise the homogeneous serving path's on the
same rows, and ``select_tenant`` is bitwise a plain index.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_config as jget_config
from repro.core.config import DoRAConfig as JConfig
from repro.launch import serve as jserve
from repro.launch.steps import StepConfig as JStep
from repro.launch.steps import make_decode_step as jmake_decode_step
from repro.launch.train import build_state as jbuild_state
from repro.models import init_cache as jinit_cache
from repro_torch import core as tcore
from repro_torch.bridge import flatten_paths, tree_from_numpy, tree_to_numpy
from repro_torch.configs import get_config
from repro_torch.core import adapter as tadapter
from repro_torch.core.adapter_cache import AdapterCacheMiss, AdapterHandle
from repro_torch.core.compose import select_tenant
from repro_torch.core.config import FORCE_TIER_ENV, DoRAConfig
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import (StepConfig, make_decode_step,
                                      make_prefill_step)
from repro_torch.models import lm as tlm

RANK, ALPHA = 4, 8.0
JDCFG = JConfig(rank=RANK, alpha=ALPHA, mode="eager")
TDCFG = DoRAConfig(rank=RANK, alpha=ALPHA, mode="auto")
ARCH, K = "qwen2-7b", 3
P, GEN, MAX_LEN = 6, 4, 12


@pytest.fixture(autouse=True)
def _no_forced_tier(monkeypatch):
    for name in ("REPRO_FORCE_TIER", "REPRO_DORA_MODE", "REPRO_DORA_FUSED",
                 FORCE_TIER_ENV):
        monkeypatch.delenv(name, raising=False)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _perturb(adapters, seed):
    """Nonzero B and m = ||W||·(1 + noise) on every adapter leaf of a numpy
    tree, in place (dtypes kept)."""
    rng = np.random.default_rng(seed)
    for name, leaf in flatten_paths(adapters).items():
        if name.split("/")[-1] == "B":
            leaf[...] = 0.2 * rng.standard_normal(leaf.shape)
        elif name.split("/")[-1] == "m":
            leaf *= 1 + 0.05 * rng.standard_normal(leaf.shape).astype(
                leaf.dtype)
    return adapters


# ---------------------------------------------------------------------------
# One linear: the grouped compose.
# ---------------------------------------------------------------------------

D_IN, D_OUT = 64, 96


def _linear_tenants(n=K, seed=0):
    """W and n perturbed raw tenants (numpy, fp32), the same for both
    packages."""
    key = jax.random.PRNGKey(seed)
    W = np.array(jax.random.normal(key, (D_OUT, D_IN), jnp.float32))
    raws = []
    for k in range(n):
        adp = jcore.init_dora_params(jax.random.fold_in(key, 1 + k),
                                     jnp.asarray(W), JDCFG)
        raws.append(_perturb({n_: np.array(v, np.float32)
                              for n_, v in adp.items()}, 50 + k))
    return W, raws


def _states(W, raws):
    """Folded serving states of each tenant in both packages."""
    j = [jcore.precompute_adapter_state(jnp.asarray(W), r, JDCFG,
                                        act_dtype=jnp.float32,
                                        fold_gsb=True) for r in raws]
    tw = torch.from_numpy(W)
    t = [tadapter.precompute_adapter_state(tw, tree_from_numpy(r), TDCFG,
                                           act_dtype=torch.float32,
                                           fold_gsb=True) for r in raws]
    return j, t


def _x(rows, seed=1):
    return np.random.default_rng(seed).standard_normal(
        rows + (D_IN,)).astype(np.float32)


@pytest.mark.parametrize("form", ["static", "dynamic"])
@pytest.mark.parametrize("seq", [1, 5])
def test_grouped_linear_matches_reference(form, seq):
    W, raws = _linear_tenants()
    jst, tst = _states(W, raws)
    x = _x((2 * K, seq))
    groups = tuple((2 * k, 2) for k in range(K))
    idx = np.repeat(np.arange(K), 2).astype(np.int32)
    tg_j = groups if form == "static" else jnp.asarray(idx)
    tg_t = groups if form == "static" else torch.from_numpy(idx)
    yj = jcore.dora_linear_grouped(
        jnp.asarray(x), jnp.asarray(W),
        jcore.stack_adapter_states(jst, axis=0), JDCFG, tg_j)
    yt = tcore.dora_linear_grouped(
        torch.from_numpy(x), torch.from_numpy(W),
        tcore.stack_adapter_states(tst, axis=0), TDCFG, tg_t)
    assert _rel(yt, yj) <= 1e-6
    # The tenants differ pairwise: the same rows under each tenant alone.
    alone = [tcore.dora_linear(torch.from_numpy(x), torch.from_numpy(W),
                               st, TDCFG, training=False) for st in tst]
    for a in range(K):
        for b in range(a + 1, K):
            assert _rel(alone[a], alone[b]) > 1e-2, (a, b)


@pytest.mark.parametrize("seq", [1, 5])
def test_grouped_delta_is_bitwise_the_homogeneous_path(seq):
    """Each group's delta is the homogeneous gsB path's (``gsb_delta``) on
    the same rows and the same y_base rows, bit for bit; the whole output
    is within 1e-6 of max of ``dora_linear`` on the group's rows alone
    (whose base product runs at M = the group's rows)."""
    W, raws = _linear_tenants()
    _, tst = _states(W, raws)
    x, w = torch.from_numpy(_x((2 * K, seq))), torch.from_numpy(W)
    stacked = tcore.stack_adapter_states(tst, axis=0)
    groups = tuple((2 * k, 2) for k in range(K))
    yg = tcore.dora_linear_grouped(x, w, stacked, TDCFG, groups)
    y_base = x @ w.T
    for k, (s, n) in enumerate(groups):
        rows = slice(s, s + n)
        st = tst[k]
        delta = tadapter.gsb_delta(y_base[rows], x[rows] @ st["A"].T,
                                   st["g"], st["gsB"])
        assert torch.equal(yg[rows], y_base[rows] + delta), k
        alone = tcore.dora_linear(x[rows], w, st, TDCFG, training=False)
        assert _rel(yg[rows], alone) <= 1e-6


def test_dynamic_form_matches_static_and_select_is_a_plain_index():
    W, raws = _linear_tenants()
    _, tst = _states(W, raws)
    x, w = torch.from_numpy(_x((2 * K, 1))), torch.from_numpy(W)
    stacked = tcore.stack_adapter_states(tst, axis=0)
    idx = torch.tensor([0, 0, 1, 1, 2, 2])
    ys = tcore.dora_linear_grouped(x, w, stacked, TDCFG,
                                   ((0, 2), (2, 2), (4, 2)))
    yd = tcore.dora_linear_grouped(x, w, stacked, TDCFG, idx)
    assert _rel(yd, ys) <= 1e-6
    # An unsorted index serves each row under its own tenant.
    perm = torch.tensor([4, 0, 2, 5, 1, 3])
    yp = tcore.dora_linear_grouped(x[perm], w, stacked, TDCFG, idx[perm])
    assert _rel(yp, ys[perm]) <= 1e-6
    all_k = torch.randn(6, 2, K, 7, generator=torch.Generator().manual_seed(0))
    sel = select_tenant(all_k, idx[perm])
    for b in range(6):
        assert torch.equal(sel[b], all_k[b, :, idx[perm][b]])
    with pytest.raises(ValueError, match="one stacked-tenant position"):
        select_tenant(all_k, idx[:5])


def test_uneven_groups_and_bias():
    W, raws = _linear_tenants(n=2)
    jst, tst = _states(W, raws)
    x = _x((5, 1))
    bias = np.random.default_rng(3).standard_normal(D_OUT).astype(np.float32)
    groups = ((0, 3), (3, 2))
    yj = jcore.dora_linear_grouped(
        jnp.asarray(x), jnp.asarray(W),
        jcore.stack_adapter_states(jst, axis=0), JDCFG, groups,
        bias=jnp.asarray(bias))
    yt = tcore.dora_linear_grouped(
        torch.from_numpy(x), torch.from_numpy(W),
        tcore.stack_adapter_states(tst, axis=0), TDCFG, groups,
        bias=torch.from_numpy(bias))
    assert _rel(yt, yj) <= 1e-6


def test_grouped_linear_refusals():
    W, raws = _linear_tenants(n=2)
    w = torch.from_numpy(W)
    x = torch.from_numpy(_x((4, 1)))
    unfolded = tcore.stack_adapter_states(
        [tadapter.precompute_adapter_state(w, tree_from_numpy(r), TDCFG)
         for r in raws], axis=0)
    with pytest.raises(ValueError, match="gsB"):
        tcore.dora_linear_grouped(x, w, unfolded, TDCFG, ((0, 2), (2, 2)))
    _, tst = _states(W, raws)
    stacked = tcore.stack_adapter_states(tst, axis=0)
    with pytest.raises(ValueError, match="serving-only"):
        tcore.dora_linear(x, w, stacked, TDCFG, training=True,
                          tenant_groups=((0, 2), (2, 2)))
    for groups, match in [(((0, 2), (3, 1)), "contiguously"),
                          (((0, 2), (2, 1)), "cover"),
                          (((0, 4),), "tenant groups but"),
                          ((), "at least one")]:
        with pytest.raises(ValueError, match=match):
            tcore.dora_linear_grouped(x, w, stacked, TDCFG, groups)
    with pytest.raises(NotImplementedError, match="stacked"):
        tcore.dora_linear_grouped(x, torch.stack([w, w]), stacked, TDCFG,
                                  ((0, 2), (2, 2)))
    with pytest.raises(NotImplementedError, match=r"\[B, S, d_in\]"):
        tcore.dora_linear_grouped(x[:, 0], w, stacked, TDCFG,
                                  torch.tensor([0, 0, 1, 1]))


# ---------------------------------------------------------------------------
# The model: stacked serving trees, the server, the refusals.
# ---------------------------------------------------------------------------

def _model(n=K):
    """qwen2-7b SMOKE: the reference's params and n perturbed tenants, as
    numpy trees."""
    jm = jget_config(ARCH, smoke=True)
    params, _, _ = jbuild_state(jm, JDCFG, 0)
    params = jax.tree_util.tree_map(np.array, params)
    tenants = []
    for t in range(n):
        _, ad, _ = jbuild_state(jm, JDCFG, 10 + t)
        tenants.append(_perturb(jax.tree_util.tree_map(np.array, ad),
                                100 + t))
    return jm, params, tenants


def _requests(cls, vocab, seed=0):
    """Two rows per tenant, interleaved so the server's sort permutes."""
    rng = np.random.default_rng(seed)
    reqs = [cls(rng.integers(0, vocab, P).astype(np.int32), f"t{t}")
            for t in range(K) for _ in range(2)]
    return [reqs[i] for i in rng.permutation(len(reqs))]


def _port_server(params, tenants, **kw):
    tm = get_config(ARCH, smoke=True)
    scfg = StepConfig(dora=TDCFG)
    cache = tcore.AdapterStateCache.for_serving(tm, scfg, device="cpu")
    for t, ad in enumerate(tenants):
        cache.register(f"t{t}", tree_from_numpy(ad))
    tparams = tree_from_numpy(params)
    server = tserve.MultiTenantServer(tm, scfg, tparams, cache=cache,
                                      device="cpu", **kw)
    return tm, scfg, tparams, cache, server


def test_server_matches_reference_server():
    jm, params, tenants = _model()
    jscfg = JStep(dora=JDCFG)
    jcache = jcore.AdapterStateCache.for_serving(jm, jscfg)
    for t, ad in enumerate(tenants):
        jcache.register(f"t{t}", ad)
    jreqs = _requests(jserve.Request, jm.vocab_size)
    j_tok, j_logits = jserve.MultiTenantServer(
        jm, jscfg, params, cache=jcache).serve(
        jreqs, gen_len=GEN, max_len=MAX_LEN, return_logits=True)

    tm, scfg, tparams, cache, server = _port_server(params, tenants)
    treqs = [tserve.Request(r.prompt, r.adapter) for r in jreqs]
    t_tok, t_logits = server.serve(treqs, gen_len=GEN, max_len=MAX_LEN,
                                   return_logits=True)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    assert len(t_logits) == GEN
    for s in range(GEN):
        assert _rel(t_logits[s], j_logits[s]) <= 1e-5, s
    assert server._steps and all(k[3] == ((0, 2), (2, 2), (4, 2))
                                 for k in server._steps)
    # The three tenants differ pairwise on one shared prompt.
    shared = np.asarray(jreqs[0].prompt)[None]
    first = [tserve.generate(tm, tparams, cache.current_handle(f"t{t}"),
                             scfg, shared, gen_len=1, max_len=MAX_LEN,
                             adapter_cache=cache, return_logits=True,
                             device="cpu")[1][0] for t in range(K)]
    for a in range(K):
        for b in range(a + 1, K):
            assert _rel(first[a], first[b]) > 1e-3, (a, b)


def test_mixed_batch_matches_own_per_tenant_generate():
    """The port's mixed batch against its own ``generate`` of each tenant
    on its rows: equal tokens, and every step's logits within 1e-6 of max
    |logit|. Not bitwise: the LM head (and at decode every base product)
    runs at M = 6 rows in the batch and M = 2 alone, and this CPU's BLAS
    does not give the same bits at both (see the prefill cache test for
    what is bitwise)."""
    _, params, tenants = _model()
    tm, scfg, tparams, cache, server = _port_server(params, tenants)
    reqs = _requests(tserve.Request, tm.vocab_size)
    toks, logits = server.serve(reqs, gen_len=GEN, max_len=MAX_LEN,
                                return_logits=True)
    for t in range(K):
        rows = [i for i, r in enumerate(reqs) if r.adapter == f"t{t}"]
        prompts = np.stack([np.asarray(reqs[i].prompt) for i in rows])
        st, sl = tserve.generate(tm, tparams, cache.current_handle(f"t{t}"),
                                 scfg, prompts, gen_len=GEN, max_len=MAX_LEN,
                                 adapter_cache=cache, return_logits=True,
                                 device="cpu")
        assert torch.equal(st, toks[rows]), t
        for s in range(GEN):
            assert _rel(logits[s][rows], sl[s]) <= 1e-6, (t, s)
    assert cache.stats().misses == K and cache.stats().hits == K


def test_grouped_prefill_cache_is_bitwise_per_tenant():
    """The grouped padded prefill's K/V cache rows are bitwise each
    tenant's own prefill of its rows (every product there runs at
    M = rows x seq, where this CPU's BLAS gives the same bits for 6 rows
    and for 2); its logits, gathered at P-1 before the head, are within
    1e-6 of max."""
    _, params, tenants = _model()
    tm, scfg, tparams, cache, _ = _port_server(params, tenants)
    states = [cache.get_state(tparams, cache.current_handle(f"t{t}"))
              for t in range(K)]
    groups = ((0, 2), (2, 2), (4, 2))
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, tm.vocab_size, (6, MAX_LEN)))
    mixed = make_prefill_step(tm, scfg, batch=6, seq=MAX_LEN, padded=True,
                              tenant_groups=groups)
    lm_, cm = mixed(tparams, tadapter.stack_adapter_states(states, axis=1),
                    {"tokens": toks, "prompt_len": P})
    alone = make_prefill_step(tm, scfg, batch=2, seq=MAX_LEN, padded=True)
    for k, (s, n) in enumerate(groups):
        la, ca = alone(tparams, states[k],
                       {"tokens": toks[s:s + n], "prompt_len": P})
        for name, leaf in flatten_paths(ca["stack"]).items():
            assert torch.equal(flatten_paths(cm["stack"])[name][:, s:s + n],
                               leaf), (k, name)
        assert _rel(lm_[s:s + n], la) <= 1e-6, k


def test_homogeneous_batch_keeps_single_tenant_path():
    _, params, tenants = _model(n=1)
    tm, scfg, tparams, cache, server = _port_server(params, tenants)
    prompts = np.random.default_rng(1).integers(0, tm.vocab_size, (4, P))
    toks = server.serve([tserve.Request(p, "t0") for p in prompts],
                        gen_len=GEN, max_len=MAX_LEN)
    ref = tserve.generate(tm, tparams, cache.current_handle("t0"), scfg,
                          prompts, gen_len=GEN, max_len=MAX_LEN,
                          adapter_cache=cache, device="cpu")
    assert torch.equal(toks, ref)
    assert all(k[3] is None for k in server._steps)


def test_stacked_serving_trees_bridge_both_ways():
    """One K-stacked serving tree ([n_scan, K, ...] leaves) handed to both
    packages through the bridge: the grouped decode logits agree within
    1e-5 of max, whichever package precomputed and stacked it."""
    jm, params, tenants = _model()
    tm = get_config(ARCH, smoke=True)
    tparams = tree_from_numpy(params)
    jstates = [jcore.precompute_adapter_state(params, ad, JDCFG,
                                              act_dtype=jnp.float32,
                                              fold_gsb=True)
               for ad in tenants]
    jstacked = jax.tree_util.tree_map(
        np.asarray, jcore.stack_adapter_states(jstates, axis=1))
    tstacked = tadapter.stack_adapter_states(
        [tadapter.precompute_adapter_state(tparams, tree_from_numpy(ad),
                                           TDCFG, act_dtype=torch.float32,
                                           fold_gsb=True)
         for ad in tenants], axis=1)
    groups = ((0, 2), (2, 2), (4, 2))
    toks = np.random.default_rng(2).integers(0, tm.vocab_size, (6, 1))
    jdec = jmake_decode_step(jm, JStep(dora=JDCFG), None, batch=6,
                             tenant_groups=groups)
    tdec = make_decode_step(tm, StepConfig(dora=TDCFG), batch=6,
                            tenant_groups=groups)

    def ref_logits(stacked_np):
        out, _ = jdec(params, stacked_np, jinit_cache(jm, 6, 8),
                      {"tokens": jnp.asarray(toks, jnp.int32)})
        return np.asarray(out)

    def port_logits(stacked_t):
        out, _ = tdec(tparams, stacked_t,
                      tlm.init_cache(tm, 6, 8, device="cpu"),
                      {"tokens": torch.from_numpy(toks)})
        return out

    to_ref = tree_to_numpy(tstacked)
    assert {k: v.shape for k, v in flatten_paths(to_ref).items()} == {
        k: v.shape for k, v in flatten_paths(jstacked).items()}
    assert all(v.shape[:2] == (tm.n_scan, K)
               for v in flatten_paths(to_ref).values())
    want = ref_logits(jstacked)
    assert _rel(ref_logits(to_ref), want) <= 1e-5
    assert _rel(port_logits(tree_from_numpy(jstacked)), want) <= 1e-5
    assert _rel(port_logits(tstacked), want) <= 1e-5


def test_server_refusals():
    _, params, tenants = _model()
    tm, scfg, tparams, cache, server = _port_server(params, tenants)
    reqs = _requests(tserve.Request, tm.vocab_size)
    prompts = np.stack([np.asarray(r.prompt) for r in reqs[:2]])
    # warm-only routing names every key field, and warming lets it pass
    with pytest.raises(AdapterCacheMiss) as ei:
        server.serve(reqs, gen_len=2, max_len=MAX_LEN, allow_miss=False)
    for field in ("adapter_id=", "version=0", "act_dtype=float32",
                  "fold_gsb=True", "sharding=None", "allow_miss"):
        assert field in str(ei.value), field
    for t in range(K):
        cache.get_state(tparams, cache.current_handle(f"t{t}"))
    server.serve(reqs, gen_len=2, max_len=MAX_LEN, allow_miss=False)
    # a stale handle is always refused, naming the key fields
    h0 = cache.current_handle("t0")
    cache.update("t0", tree_from_numpy(tenants[1]))
    with pytest.raises(AdapterCacheMiss) as ei:
        tserve.generate(tm, tparams, h0, scfg, prompts, gen_len=2,
                        max_len=MAX_LEN, adapter_cache=cache, device="cpu")
    for field in ("stale adapter handle", "adapter_id='t0'", "version=0",
                  "act_dtype", "fold_gsb"):
        assert field in str(ei.value), field
    with pytest.raises(AdapterCacheMiss, match="not registered"):
        tserve.generate(tm, tparams, AdapterHandle("ghost", 0), scfg,
                        prompts, gen_len=2, max_len=MAX_LEN,
                        adapter_cache=cache, device="cpu")
    with pytest.raises(KeyError, match="not registered"):
        server.serve([tserve.Request(prompts[0], "ghost")], gen_len=2,
                     max_len=MAX_LEN)
    with pytest.raises(ValueError, match="already registered"):
        cache.register("t1", tree_from_numpy(tenants[0]))
    with pytest.raises(ValueError, match="adapter_cache"):
        tserve.generate(tm, tparams, cache.current_handle("t1"), scfg,
                        prompts, gen_len=2, max_len=MAX_LEN, device="cpu")
    # a mesh: the port serves on one card (ROADMAP queue 1 item 6)
    for call in (
            lambda: tserve.MultiTenantServer(tm, scfg, tparams, cache=cache,
                                             mesh=object(), device="cpu"),
            lambda: tserve.generate(tm, tparams, cache.current_handle("t1"),
                                    scfg, prompts, gen_len=2,
                                    max_len=MAX_LEN, adapter_cache=cache,
                                    mesh=object(), device="cpu"),
            lambda: tcore.AdapterStateCache.for_serving(
                tm, scfg, mesh=object(), device="cpu")):
        with pytest.raises(NotImplementedError, match="queue 1 item 6"):
            call()
    other = tcore.AdapterStateCache(lambda p, a: a,
                                    sharding=(("model", 4),))
    with pytest.raises(ValueError, match="keyed for sharding"):
        tserve.MultiTenantServer(tm, scfg, tparams, cache=other,
                                 device="cpu")
    # the engine route (mixed lengths, static=False, speculative_k) keeps
    # the reference's contracts: no logits, no contract check, room for
    # every prompt's tokens
    mixed = [tserve.Request(np.arange(6), "t0"),
             tserve.Request(np.arange(7), "t1")]
    for kw, match in (({"return_logits": True}, "return_logits"),
                      ({"check_contract": True}, "check_contract"),
                      ({"static": False, "return_logits": True},
                       "return_logits"),
                      ({"speculative_k": 2, "check_contract": True},
                       "check_contract")):
        with pytest.raises(ValueError, match=match):
            server.serve(mixed if "static" not in kw else reqs, gen_len=2,
                         max_len=MAX_LEN, **kw)
    with pytest.raises(ValueError, match="P\\+gen_len"):
        server.serve(mixed, gen_len=MAX_LEN - 6, max_len=MAX_LEN)
    assert not server._engines or not any(
        e.has_work() for e in server._engines.values())
    with pytest.raises(ValueError, match="length bucket"):
        server.serve(mixed, gen_len=2, max_len=MAX_LEN, static=True)
    with pytest.raises(ValueError, match="speculative_k requires"):
        server.serve(reqs, gen_len=2, max_len=MAX_LEN, static=True,
                     speculative_k=2)
    with pytest.raises(ValueError, match="empty request batch"):
        server.serve([], gen_len=2, max_len=MAX_LEN)


def test_model_refusals_and_no_card_fallback():
    tm = get_config(ARCH, smoke=True)
    params, adapters = tserve.build_state(tm, TDCFG, 0, "cpu")
    toks = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="serving-only"):
        tlm.forward(tm, params, adapters, TDCFG, tokens=toks, training=True,
                    tenant_groups=((0, 2),))
    fm = get_config("falcon-mamba-7b", smoke=True)
    fparams, fadapters = tserve.build_state(fm, TDCFG, 0, "cpu")
    with pytest.raises(NotImplementedError, match="attention"):
        tlm.forward(fm, fparams, fadapters, TDCFG, tokens=toks[:, :1],
                    cache=tlm.init_cache(fm, 2, 4, device="cpu"),
                    training=False, tenant_groups=((0, 2),))
    with pytest.raises(ValueError, match="adapter_idx"):
        make_decode_step(tm, StepConfig(dora=TDCFG), batch=2,
                         tenant_groups=((0, 2),), dynamic_groups=True)
    # device=None is the card: with none here, both refuse
    cache = tcore.AdapterStateCache(lambda p, a: a)
    with pytest.raises(RuntimeError, match="CUDA unavailable"):
        tserve.MultiTenantServer(tm, StepConfig(dora=TDCFG), params,
                                 cache=cache)
    with pytest.raises(RuntimeError, match="CUDA unavailable"):
        tcore.AdapterStateCache.for_serving(tm, StepConfig(dora=TDCFG))
    # a cache built for the CPU refuses params that live elsewhere
    cpu_cache = tcore.AdapterStateCache.for_serving(
        tm, StepConfig(dora=TDCFG), device="cpu")
    h = cpu_cache.register("t", adapters)
    with pytest.raises(ValueError, match="params live on meta"):
        cpu_cache.get_state({"embed": torch.empty(1, device="meta")}, h)


def test_dynamic_decode_step_matches_static():
    """The decode step with ``dynamic_groups`` (``adapter_idx``) against
    the static grouping: logits within 1e-6 of max |logit|."""
    _, params, tenants = _model()
    tm, scfg, tparams, cache, _ = _port_server(params, tenants)
    stacked = tadapter.stack_adapter_states(
        [cache.get_state(tparams, cache.current_handle(f"t{t}"))
         for t in range(K)], axis=1)
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, tm.vocab_size, (6, 1)))
    static = make_decode_step(tm, scfg, batch=6,
                              tenant_groups=((0, 2), (2, 2), (4, 2)))
    dynamic = make_decode_step(tm, scfg, batch=6, dynamic_groups=True)
    ls, _ = static(tparams, stacked, tlm.init_cache(tm, 6, 8, device="cpu"),
                   {"tokens": toks})
    ld, _ = dynamic(tparams, stacked, tlm.init_cache(tm, 6, 8, device="cpu"),
                    {"tokens": toks,
                     "adapter_idx": torch.tensor([0, 0, 1, 1, 2, 2])})
    assert _rel(ld, ls) <= 1e-6


def test_step_cache_is_bounded():
    _, params, tenants = _model(n=1)
    tm, scfg, tparams, cache, server = _port_server(params, tenants,
                                                    max_cached_steps=2)
    rng = np.random.default_rng(5)
    for n in range(3):           # three distinct bucket signatures
        prompts = rng.integers(0, tm.vocab_size, (2, P))
        server.serve([tserve.Request(p, "t0") for p in prompts], gen_len=1,
                     max_len=MAX_LEN + n)
    assert [k[1] for k in server._steps] == [MAX_LEN + 1, MAX_LEN + 2]


def test_cli_serves_tenants_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                 "--tenants", "3", "--batch", "2", "--prompt-len", "5",
                 "--gen-len", "3"])
    out = capsys.readouterr().out
    assert "served 6 requests x 3 tenants on cpu" in out
    assert "0 hits / 3 misses" in out
