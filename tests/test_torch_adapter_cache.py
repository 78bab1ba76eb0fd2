"""The port's adapter-state LRU (``repro_torch.core.adapter_cache``):
eviction order and byte accounting under small ``max_bytes``, the
oversized-entry rule, hits bitwise the recomputed state, invalidation on
a version bump, the warm-only (``allow_miss=False``) refusal naming every
key field, the host spill tier (spill, bitwise reload, drop, the thrash
window), and ``CacheStats`` equal to the reference's: on one mixed call
sequence through both packages, and on ``benchmarks/serve_bench.py:
run_multitenant``'s sequence at qwen2-7b SMOKE, r = 64, against the
committed ``BENCH_serve.json`` ``multi_tenant.cache``.

Tenants have a nonzero B and m off ||W||, so their states differ.
"""
import json
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from repro import core as jcore
from repro.configs import get_config as jget_config
from repro.core.config import DoRAConfig as JConfig
from repro.launch.steps import StepConfig as JStep
from repro.launch.train import build_state as jbuild_state
from repro_torch.configs import get_config
from repro_torch.core import adapter_cache as ac
from repro_torch.core.adapter import (invalidate_adapter_state,
                                      precompute_adapter_state)
from repro_torch.core.config import DoRAConfig
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import StepConfig

ROOT = Path(__file__).resolve().parents[1]
DCFG = DoRAConfig(rank=4, alpha=8.0, mode="eager")
D_OUT, D_IN = 32, 24
R = DCFG.rank
# One tenant's counted bytes, the full fp32 state tree: A, B, m, g, gsB.
STATE_BYTES = 4 * (R * D_IN + D_OUT * R + D_OUT + D_OUT + D_OUT * R)


def _precompute(W, adapters):
    return precompute_adapter_state(W, adapters, DCFG,
                                    act_dtype=torch.float32, fold_gsb=True)


def _W():
    return torch.randn(D_OUT, D_IN, generator=torch.Generator().manual_seed(99))


def _tenant(seed: int):
    g = torch.Generator().manual_seed(seed)
    return {"A": torch.randn(R, D_IN, generator=g) / D_IN ** 0.5,
            "B": 0.2 * torch.randn(D_OUT, R, generator=g),
            "m": 1.0 + torch.rand(D_OUT, generator=g)}


def _cache(**kw):
    return ac.AdapterStateCache(_precompute, act_dtype=torch.float32,
                                fold_gsb=True, **kw)


def _ids(keys):
    return [k.adapter_id for k in keys]


def test_state_bytes_count_the_full_tree():
    W, cache = _W(), _cache()
    state = cache.get_state(W, cache.register("a", _tenant(0)))
    assert ac.serving_state_nbytes(state) == STATE_BYTES
    assert cache.stats().current_bytes == STATE_BYTES
    assert ac.serving_state_nbytes(invalidate_adapter_state(state)) == \
        STATE_BYTES - 4 * (D_OUT + D_OUT * R)
    # The port's state shares A/B/m with the registry: it adds only g, gsB.
    raw = cache.adapters("a")
    assert all(state[k] is raw[k] for k in ("A", "B", "m"))


def test_lru_eviction_order_and_oversized_entry():
    W = _W()
    cache = _cache(max_bytes=2 * STATE_BYTES)
    hs = [cache.register(f"t{i}", _tenant(i)) for i in range(3)]
    cache.get_state(W, hs[0])
    cache.get_state(W, hs[1])
    cache.get_state(W, hs[0])            # t1 becomes the LRU victim
    cache.get_state(W, hs[2])
    assert _ids(cache.cached_keys()) == ["t0", "t2"]
    st = cache.stats()
    assert (st.evictions, st.entries, st.current_bytes) == (
        1, 2, 2 * STATE_BYTES)
    small = _cache(max_bytes=STATE_BYTES // 2)
    small.get_state(W, small.register("big", _tenant(0)))
    assert small.stats().entries == 1            # kept: serving proceeds
    small.get_state(W, small.register("big2", _tenant(1)))
    assert _ids(small.cached_keys()) == ["big2"]


def test_hit_is_the_recomputed_state_and_tenants_differ():
    W, cache = _W(), _cache()
    adp = _tenant(3)
    h = cache.register("t", adp)
    miss = cache.get_state(W, h)
    hit = cache.get_state(W, h)
    assert hit is miss
    fresh = _precompute(W, adp)
    for k in ("g", "gsB"):
        assert torch.equal(hit[k], fresh[k])
    other = cache.get_state(W, cache.register("u", _tenant(4)))
    assert not torch.allclose(other["g"], hit["g"], rtol=1e-3)
    assert (cache.stats().hits, cache.stats().misses) == (1, 2)


def test_versions_and_invalidation():
    W, cache = _W(), _cache()
    adp = _tenant(0)
    served = _precompute(W, adp)
    h0 = cache.register("t", served)             # serving leaves stripped
    assert set(cache.adapters("t")) == {"A", "B", "m"}
    pinned = cache.get_state(W, h0)
    before = {k: v.clone() for k, v in pinned.items()}
    adp2 = {**adp, "B": adp["B"] + 0.1}
    h1 = cache.update("t", adp2)
    assert h1.version == 1 and cache.stats().entries == 0
    assert cache.stats().invalidations == 1
    for k, v in before.items():                  # a fetched state stays
        assert torch.equal(pinned[k], v)
    with pytest.raises(ac.AdapterCacheMiss, match="stale adapter handle"):
        cache.get_state(W, h0)
    assert torch.equal(cache.get_state(W, h1)["g"], _precompute(W, adp2)["g"])
    assert cache.invalidate("t") == 1
    cache.get_state(W, h1)                       # still registered
    assert cache.stats().misses == 3
    with pytest.raises(KeyError, match="not registered"):
        cache.update("ghost", adp)


def test_warm_only_routing_and_registry_refusals():
    W, cache = _W(), _cache()
    h = cache.register("prod-adapter", _tenant(0))
    with pytest.raises(ac.AdapterCacheMiss) as ei:
        cache.get_state(W, h, allow_miss=False)
    for field in ("prod-adapter", "version=0", "act_dtype=float32",
                  "fold_gsb=True", "sharding=None", "allow_miss"):
        assert field in str(ei.value), field
    assert ei.value.key.adapter_id == "prod-adapter"
    cache.get_state(W, h)
    cache.get_state(W, h, allow_miss=False)
    with pytest.raises(ac.AdapterCacheMiss, match="not registered"):
        cache.get_state(W, ac.AdapterHandle("ghost", 0))
    with pytest.raises(ValueError, match="already registered"):
        cache.register("prod-adapter", _tenant(1))
    with pytest.raises(ValueError, match="thrash_window"):
        _cache(thrash_window=0)


def test_key_fields_and_mesh_fingerprint():
    cache = ac.AdapterStateCache(_precompute, act_dtype=torch.bfloat16,
                                 fold_gsb=False, sharding=(("model", 4),))
    cache.register("t", _tenant(0))
    key = cache.make_key(cache.current_handle("t"))
    assert (key.act_dtype, key.fold_gsb, key.sharding) == (
        "bfloat16", False, (("model", 4),))
    assert hash(key) == hash(ac.AdapterKey("t", 0, "bfloat16", False,
                                           (("model", 4),)))
    assert ac.mesh_fingerprint(None) is None

    class DuckMesh:
        axis_names = ("data", "model")
        shape = {"model": 4, "data": 2}

    assert ac.mesh_fingerprint(DuckMesh()) == (("data", 2), ("model", 4))
    assert jcore.adapter_cache.mesh_fingerprint(DuckMesh()) == \
        ac.mesh_fingerprint(DuckMesh())


def test_host_tier_spill_reload_and_drop():
    W = _W()
    cache = _cache(max_bytes=2 * STATE_BYTES, host_max_bytes=10 * STATE_BYTES)
    events = []
    cache.on_event = lambda kind, key: events.append((kind, key.adapter_id))
    hs = [cache.register(f"t{i}", _tenant(i)) for i in range(3)]
    fresh = {h: {k: v.clone() for k, v in cache.get_state(W, h).items()}
             for h in hs}
    st = cache.stats()
    assert (st.entries, st.host_entries, st.spills) == (2, 1, 1)
    assert (st.current_bytes, st.host_bytes) == (2 * STATE_BYTES,
                                                 STATE_BYTES)
    for h in hs:
        assert cache.is_resident(h) != cache.is_spilled(h)
    state = cache.get_state(W, hs[0], allow_miss=False)    # a reload
    st = cache.stats()
    assert (st.reloads, st.misses) == (1, 3)
    for k, v in fresh[hs[0]].items():
        assert torch.equal(state[k], v)
    assert cache.is_resident(hs[0]) and not cache.is_spilled(hs[0])
    assert events == [("spill", "t0"), ("reload", "t0"), ("spill", "t1")]
    # the host budget drops the oldest spill
    tight = _cache(max_bytes=STATE_BYTES, host_max_bytes=2 * STATE_BYTES)
    hs = [tight.register(f"t{i}", _tenant(i)) for i in range(4)]
    for h in hs:
        tight.get_state(W, h)
    st = tight.stats()
    assert (st.spills, st.host_drops, st.host_entries) == (3, 1, 2)
    assert _ids(tight.spilled_keys()) == ["t1", "t2"]
    tight.get_state(W, hs[0])                    # dropped: cold again
    assert tight.stats().misses == 5
    # a version bump and invalidate() clear both tiers
    assert _ids(tight.spilled_keys()) == ["t2", "t3"]
    tight.update("t2", {**_tenant(2), "B": _tenant(2)["B"] + 0.1})
    assert not tight.is_spilled(hs[2]) and tight.stats().host_entries == 1
    assert tight.invalidate() == 2
    assert (tight.stats().entries, tight.stats().host_bytes) == (0, 0)


def test_thrash_window():
    W = _W()
    cache = _cache(max_bytes=STATE_BYTES, thrash_window=2)
    hs = [cache.register(f"t{i}", _tenant(i)) for i in range(3)]
    cache.get_state(W, hs[0])
    cache.get_state(W, hs[1])                    # evicting miss
    assert not cache.thrashing()
    cache.get_state(W, hs[2])                    # two in a row
    assert cache.thrashing() and cache.stats().thrashing
    cache.invalidate("t0")                       # an explicit drop is not
    assert not cache.thrashing()
    # reloads are warm traffic: with a host tier the window never fills
    tiered = _cache(max_bytes=STATE_BYTES, host_max_bytes=10 * STATE_BYTES,
                    thrash_window=2)
    hs = [tiered.register(f"t{i}", _tenant(i)) for i in range(2)]
    tiered.get_state(W, hs[0])
    tiered.get_state(W, hs[1])
    for _ in range(4):
        tiered.get_state(W, hs[0])
        tiered.get_state(W, hs[1])
    assert tiered.stats().reloads == 8 and not tiered.thrashing()


def _np_tenant(seed):
    t = _tenant(seed)
    return {k: v.numpy() for k, v in t.items()}


def test_cache_stats_equal_reference_on_one_call_sequence():
    """One sequence of registers, lookups, an update and an invalidate
    through the reference's cache and the port's, each on its own
    precompute of the same numpy tenants: equal ``CacheStats`` after every
    call."""
    W = _W()
    jcfg = JConfig(rank=4, alpha=8.0, mode="eager")

    def jpre(w, a):
        return jcore.precompute_adapter_state(w, a, jcfg,
                                              act_dtype=jnp.float32,
                                              fold_gsb=True)

    kw = dict(max_bytes=2 * STATE_BYTES, host_max_bytes=STATE_BYTES,
              thrash_window=3)
    jc = jcore.AdapterStateCache(jpre, act_dtype=jnp.float32, **kw)
    tc = _cache(**kw)
    jW = jnp.asarray(W.numpy())
    ops = [("register", 0), ("register", 1), ("register", 2),
           ("register", 3), ("get", 0), ("get", 1), ("get", 0), ("get", 2),
           ("get", 3), ("get", 1), ("get", 2), ("update", 2), ("get", 2),
           ("get", 0), ("invalidate", 1), ("get", 1), ("get", 3),
           ("get", 3)]
    for i, (op, t) in enumerate(ops):
        name = f"t{t}"
        if op == "register":
            jc.register(name, _np_tenant(t))
            tc.register(name, _tenant(t))
        elif op == "update":
            jc.update(name, _np_tenant(10 + t))
            tc.update(name, _tenant(10 + t))
        elif op == "invalidate":
            assert jc.invalidate(name) == tc.invalidate(name)
        else:
            jc.get_state(jW, jc.current_handle(name))
            tc.get_state(W, tc.current_handle(name))
        assert tc.stats().as_dict() == jc.stats().as_dict(), (i, op, t)
        assert _ids(tc.cached_keys()) == _ids(jc.cached_keys())
        assert _ids(tc.spilled_keys()) == _ids(jc.spilled_keys())
    st = tc.stats()
    assert st.spills and st.reloads and st.host_drops and st.evictions


def test_cache_stats_equal_bench_serve_multitenant():
    """``run_multitenant``'s sequence at qwen2-7b SMOKE, r = 64 (three
    tenants registered, each precomputed, the cache invalidated, each
    precomputed again) gives the committed ``multi_tenant.cache``."""
    want = json.loads((ROOT / "BENCH_serve.json").read_text())[
        "multi_tenant"]["cache"]
    rank = 64
    mcfg = get_config("qwen2-7b", smoke=True)
    dcfg = DoRAConfig(rank=rank, alpha=2.0 * rank, mode="auto")
    scfg = StepConfig(dora=dcfg)
    params, _ = tserve.build_state(mcfg, dcfg, 0, "cpu")
    cache = ac.AdapterStateCache.for_serving(mcfg, scfg, device="cpu")
    handles = []
    for t in range(3):
        _, ad = tserve.build_state(mcfg, dcfg, 10 + t, "cpu")
        handles.append(cache.register(f"tenant-{t}", ad))
    for h in handles:
        cache.get_state(params, h)
    cache.invalidate()
    for h in handles:
        cache.get_state(params, h)
    assert cache.stats().as_dict() == want
    # the reference's cache on its own SMOKE model, the same sequence
    jm = jget_config("qwen2-7b", smoke=True)
    jd = JConfig(rank=rank, alpha=2.0 * rank, mode="auto")
    jparams, _, _ = jbuild_state(jm, jd, 0)
    jc = jcore.AdapterStateCache.for_serving(jm, JStep(dora=jd))
    jh = [jc.register(f"tenant-{t}", jbuild_state(jm, jd, 10 + t)[1])
          for t in range(3)]
    for h in jh:
        jc.get_state(jparams, h)
    jc.invalidate()
    for h in jh:
        jc.get_state(jparams, h)
    assert jc.stats().as_dict() == want
