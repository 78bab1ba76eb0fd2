"""Cache routing in the port's ``DecodeEngine`` and ``MultiTenantServer``'s
engine route, against the reference and against each request served
alone (``test_torch_fleet.py``'s model and perturbed tenants).

  - the engine's adapter source, the pin at submit (a stale handle fails
    there, an ``update()`` mid-request changes nothing), results
    delivered once, a cache keyed for another layout refused;
  - the faults that now have a target: ``stale`` takes the cache's real
    stale error, ``evict`` and ``slow`` change no token, ``EngineBusy``
    on a thrashing cache, a spilled state exempt from it, and a run under
    a plan of ``evict`` and ``stale`` events whose ``stats()`` are the
    reference's;
  - ``MultiTenantServer.serve`` through the engine: mixed lengths against
    each request alone, a failed call that leaves the cached engine
    servable, a bad request that queues nothing, temperature sampling
    reproducible across calls, uniform lengths forced through the engine
    equal to the static path, and ``speculative_k``.
"""
from __future__ import annotations

import pickle

import numpy as np
import pytest

from repro.launch.faults import FaultPlan as JPlan
from repro_torch import core as tcore
from repro_torch.bridge import tree_from_numpy
from repro_torch.core.adapter_cache import AdapterCacheMiss
from repro_torch.launch import serve as tserve
from repro_torch.launch.engine import DecodeEngine, EngineBusy
from repro_torch.launch.faults import FaultPlan

from test_torch_fleet import (ML, Fleet, _no_forced_tier,  # noqa: F401
                              _one_thread)


@pytest.fixture(scope="module")
def fleet():
    return Fleet()


def prompts_of(fleet, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, fleet.tm.vocab_size, n, dtype=np.int32)
            for n in lens]


# ---------------------------------------------------------------------------
# The engine's cache routing.
# ---------------------------------------------------------------------------

def test_engine_requires_exactly_one_adapter_source(fleet):
    cache = fleet.port_cache(1)
    with pytest.raises(ValueError, match="not both, not neither"):
        DecodeEngine(fleet.tm, fleet.scfg, fleet.tparams, slots=2,
                     max_len=8, device="cpu")
    state = cache.get_state(fleet.tparams, cache.current_handle("t0"))
    with pytest.raises(ValueError, match="not both, not neither"):
        DecodeEngine(fleet.tm, fleet.scfg, fleet.tparams, slots=2,
                     max_len=8, adapters=state, adapter_cache=cache,
                     device="cpu")
    eng = fleet.port_engine(cache, slots=1, max_len=8)
    with pytest.raises(ValueError, match="every request must carry"):
        eng.submit(np.zeros(3, np.int32), max_new_tokens=2)
    with pytest.raises(KeyError, match="not registered"):
        eng.submit(np.zeros(3, np.int32), adapter="ghost", max_new_tokens=2)
    assert not eng.has_work()


def test_stale_handle_fails_at_submit_without_wedging(fleet):
    cache = fleet.port_cache(1)
    eng = fleet.port_engine(cache, slots=1, max_len=10)
    p0, p1 = prompts_of(fleet, 12, (4, 4))
    stale = cache.current_handle("t0")
    cache.update("t0", tree_from_numpy(fleet.variant(0, 99)))
    with pytest.raises(AdapterCacheMiss, match="stale adapter handle"):
        eng.submit(p0, adapter=stale, max_new_tokens=2)
    assert not eng.has_work()
    eng.submit(p1, adapter="t0", max_new_tokens=2)
    (r1,) = eng.run()
    assert r1.finish_reason == "length" and r1.tokens.shape == (2,)
    assert not eng.has_work() and eng.stats().admitted == 1


def test_update_mid_request_keeps_the_submitted_version(fleet):
    """An ``update()`` while one request decodes and another waits in the
    queue changes neither: both stream the version they were submitted
    against, and only the next submission serves the new one."""
    cache = fleet.port_cache(1)
    old_h = cache.update("t0", tree_from_numpy(fleet.variant(0, 1)))
    prompts = prompts_of(fleet, 21, (4, 4, 4))
    want_old = [fleet.alone(cache, p, 3, "t0", max_len=12)[0]
                for p in prompts[:2]]
    eng = fleet.port_engine(cache, slots=1, max_len=12)
    eng.submit(prompts[0], adapter="t0", max_new_tokens=3)
    eng.submit(prompts[1], adapter="t0", max_new_tokens=3)
    eng.step()                  # admits r0 only; r1 waits in the queue
    new_h = cache.update("t0", tree_from_numpy(fleet.variant(0, 2)))
    assert new_h.version == old_h.version + 1
    eng.submit(prompts[2], adapter="t0", max_new_tokens=3)
    want_new = fleet.alone(cache, prompts[2], 3, "t0", max_len=12)[0]
    r0, r1, r2 = eng.run()
    assert [r.finish_reason for r in (r0, r1, r2)] == ["length"] * 3
    assert r0.tokens.tolist() == want_old[0]
    assert r1.tokens.tolist() == want_old[1]
    assert r2.tokens.tolist() == want_new
    assert want_old[0] != fleet.alone(cache, prompts[0], 3, "t0",
                                      max_len=12)[0] \
        or want_old[1] != fleet.alone(cache, prompts[1], 3, "t0",
                                      max_len=12)[0]


def test_run_delivers_results_exactly_once(fleet):
    cache = fleet.port_cache(1)
    eng = fleet.port_engine(cache, slots=1, max_len=8)
    p0, p1 = prompts_of(fleet, 13, (4, 4))
    eng.submit(p0, adapter="t0", max_new_tokens=2)
    assert len(eng.run()) == 1
    assert eng.results() == [] and eng.run() == []
    eng.submit(p1, adapter="t0", max_new_tokens=2)
    assert [r.request_id for r in eng.run()] == [1]


def test_cache_keyed_for_another_layout_is_refused(fleet):
    other = tcore.AdapterStateCache(lambda p, a: a,
                                    sharding=(("model", 4),))
    with pytest.raises(ValueError, match="keyed for sharding"):
        fleet.port_engine(other, slots=2, max_len=8)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        fleet.port_engine(fleet.port_cache(1), slots=2, max_len=8,
                          mesh=object())


# ---------------------------------------------------------------------------
# The faults that now have a target.
# ---------------------------------------------------------------------------

def test_stale_injection_takes_the_real_miss_path(fleet):
    cache = fleet.port_cache(1)
    p0, p1 = prompts_of(fleet, 10, (5, 4))
    eng = fleet.port_engine(cache, slots=1, max_len=12,
                            fault_plan=FaultPlan.parse("stale@0"))
    eng.submit(p0, adapter="t0", max_new_tokens=3)
    eng.submit(p1, adapter="t0", max_new_tokens=3)
    r0, r1 = eng.run()
    assert r0.finish_reason == "error"
    assert r0.error_type == "AdapterCacheMiss"
    assert "stale" in r0.error_message and r0.tokens.shape == (0,)
    assert isinstance(r0.error, AdapterCacheMiss)
    back = pickle.loads(pickle.dumps(r0))
    assert back.error is None and back.error_type == "AdapterCacheMiss"
    assert r1.finish_reason == "length"
    assert r1.tokens.tolist() == fleet.alone(cache, p1, 3, "t0",
                                             max_len=12)[0]
    assert eng.stats().stale_injected == 1


def test_evict_and_slow_change_no_tokens(fleet):
    reqs = [(p, 4) for p in prompts_of(fleet, 11, (5, 6))]

    def drive(plan):
        cache = fleet.port_cache(1)
        eng = fleet.port_engine(cache, slots=2, max_len=12, fault_plan=plan)
        for p, g in reqs:
            eng.submit(p, adapter="t0", max_new_tokens=g)
        return eng.run(), eng.stats(), cache.stats()

    clean, _, _ = drive(None)
    faulty, st, cst = drive(FaultPlan.parse("evict@1,slow@2:0"))
    assert st.forced_evictions == 1 and st.slow_ticks == 1
    assert cst.invalidations == 1 and cst.entries == 0
    for a, b in zip(clean, faulty):
        assert a.tokens.tolist() == b.tokens.tolist()
        assert a.finish_reason == b.finish_reason


def thrash(cache, params, a="t0", b="t1"):
    """Fill the cache's window with evicting misses: one state fits, and
    the two tenants alternate."""
    h0, h1 = cache.current_handle(a), cache.current_handle(b)
    cache.get_state(params, h0)
    cache.max_bytes = cache.stats().current_bytes
    for _ in range(3):
        cache.get_state(params, h1)
        cache.get_state(params, h0)
    assert cache.thrashing() and cache.is_resident(h0)


def test_busy_backpressure_on_a_thrashing_cache(fleet):
    cache = fleet.port_cache(2)
    thrash(cache, fleet.tparams)
    eng = fleet.port_engine(cache, slots=1, max_len=10)
    (p,) = prompts_of(fleet, 13, (4,))
    with pytest.raises(EngineBusy) as ei:
        eng.submit(p, adapter="t1", max_new_tokens=2)
    assert ei.value.retry_after == cache.thrash_window == 4
    assert not eng.has_work()
    assert eng.stats().busy_rejections == 1
    eng.submit(p, adapter="t0", max_new_tokens=2)
    (r,) = eng.run()
    assert r.finish_reason == "length" and r.tokens.shape == (2,)


def test_spilled_handle_is_exempt_from_backpressure(fleet):
    cache = fleet.port_cache(3)
    h0, h1, h2 = (cache.current_handle(f"t{t}") for t in range(3))
    cache.get_state(fleet.tparams, h0)
    cache.max_bytes = cache.stats().current_bytes
    cache.host_max_bytes = 10 * cache.max_bytes
    cache.get_state(fleet.tparams, h1)
    assert cache.is_spilled(h0)
    cache.host_max_bytes = None
    for _ in range(3):
        cache.get_state(fleet.tparams, h2)
        cache.get_state(fleet.tparams, h1)
    assert cache.thrashing() and cache.is_spilled(h0)
    eng = fleet.port_engine(cache, slots=1, max_len=10, allow_miss=False)
    (p,) = prompts_of(fleet, 14, (4,))
    eng.submit(p, adapter="t0", max_new_tokens=2)
    (r,) = eng.run()
    assert r.finish_reason == "length" and r.tokens.shape == (2,)
    assert eng.stats().busy_rejections == 0
    assert cache.stats().reloads >= 1


def test_stale_handle_still_raises_through_backpressure(fleet):
    cache = fleet.port_cache(2)
    stale = cache.current_handle("t0")
    cache.update("t0", tree_from_numpy(fleet.variant(0, 99)))
    thrash(cache, fleet.tparams)
    eng = fleet.port_engine(cache, slots=1, max_len=10)
    (p,) = prompts_of(fleet, 15, (4,))
    with pytest.raises(AdapterCacheMiss, match="stale"):
        eng.submit(p, adapter=stale, max_new_tokens=2)
    assert eng.stats().busy_rejections == 0 and not eng.has_work()


@pytest.mark.parametrize("paged", [False, True])
def test_plan_of_evictions_and_stale_handles_matches_reference(fleet, paged):
    """Three tenants through two slots under ``evict`` and ``stale`` events
    (and a NaN), four requests submitted after the first eviction so that
    their states are precomputed again: the port's results, ``stats()``
    and ``CacheStats`` are the reference's (paged: under dynamic
    grouping)."""
    spec = "evict@1,stale@2,nan@4:1,evict@5,stale@6"
    prompts = prompts_of(fleet, 16, (5, 4, 6, 5, 4, 6, 5, 4, 6))
    out = {}
    for pkg in ("port", "ref"):
        cache = getattr(fleet, f"{pkg}_cache")(3)
        plan = (FaultPlan if pkg == "port" else JPlan).parse(spec)
        eng = getattr(fleet, f"{pkg}_engine")(
            cache, slots=2, max_len=ML, fault_plan=plan, paged=paged,
            dynamic_grouping=paged)
        for i, p in enumerate(prompts):
            if i == 5:
                for _ in range(3):
                    eng.step()
            eng.submit(p, adapter=f"t{i % 3}", max_new_tokens=4, key_id=i)
        res = {r.request_id: (r.tokens.tolist(), r.finish_reason,
                              r.error_type)
               for r in eng.run()}
        out[pkg] = (res, eng.stats().as_dict(), cache.stats().as_dict())
    assert out["port"] == out["ref"]
    res, st, cst = out["port"]
    assert st["forced_evictions"] == 2 and st["stale_injected"] == 2
    assert [r[2] for r in res.values() if r[1] == "error"] == \
        ["AdapterCacheMiss"] * 2
    assert st["quarantined"] == 1 and cst["misses"] > 3


# ---------------------------------------------------------------------------
# MultiTenantServer's engine route.
# ---------------------------------------------------------------------------

def server_of(fleet, n=2, **kw):
    cache = fleet.port_cache(n)
    return cache, tserve.MultiTenantServer(
        fleet.tm, fleet.scfg, fleet.tparams, cache=cache, device="cpu", **kw)


@pytest.mark.parametrize("kw", [{}, {"dynamic_grouping": True,
                                     "max_active_per_adapter": 1,
                                     "engine_slots": 2}])
def test_server_routes_mixed_lengths_through_the_engine(fleet, kw):
    cache, server = server_of(fleet, **kw)
    lens = (5, 7, 6)
    reqs = [tserve.Request(p, f"t{t}") for p, t in
            zip(prompts_of(fleet, 10, lens), (0, 1, 0))]
    out = server.serve(reqs, gen_len=3, max_len=12)
    assert isinstance(out, list) and [len(o) for o in out] == [8, 10, 9]
    for row, r in zip(out, reqs):
        p = np.asarray(r.prompt)
        assert row[:len(p)].tolist() == p.tolist()
        assert row[len(p):].tolist() == fleet.alone(cache, p, 3, r.adapter,
                                                    max_len=12)[0]
    (eng,) = server._engines.values()
    assert eng.slots == kw.get("engine_slots", 8)
    assert eng._dynamic == kw.get("dynamic_grouping", False)
    with pytest.raises(ValueError, match="length bucket"):
        server.serve(reqs, gen_len=3, max_len=12, static=True)
    with pytest.raises(ValueError, match="return_logits"):
        server.serve(reqs, gen_len=3, max_len=12, return_logits=True)


def test_failed_serve_does_not_poison_the_cached_engine(fleet):
    cache, server = server_of(fleet)
    stale = cache.current_handle("t0")
    cache.update("t0", tree_from_numpy(fleet.variant(0, 98)))
    a, b, c, d = prompts_of(fleet, 14, (5, 6, 5, 6))
    with pytest.raises(AdapterCacheMiss, match="stale"):
        server.serve([tserve.Request(a, stale), tserve.Request(b, "t1")],
                     gen_len=2, max_len=10)
    out = server.serve([tserve.Request(c, "t0"), tserve.Request(d, "t1")],
                       gen_len=2, max_len=10)
    assert [len(o) for o in out] == [7, 8]


def test_bad_request_mid_batch_queues_nothing(fleet):
    _, server = server_of(fleet, n=1, engine_slots=2)
    (p,) = prompts_of(fleet, 16, (5,))
    ok = tserve.Request(p, "t0")
    with pytest.raises(KeyError, match="not registered"):
        server.serve([ok, tserve.Request(p[:4], "typo-id")], gen_len=2,
                     max_len=10)
    with pytest.raises(ValueError, match="P \\+ 1 <= max_len|P\\+gen_len"):
        server.serve([ok, tserve.Request(np.zeros(10, np.int32), "t0")],
                     gen_len=2, max_len=10)
    assert not any(e.has_work() for e in server._engines.values())
    out = server.serve([ok, tserve.Request(p[:4], "t0")], gen_len=2,
                       max_len=10)
    assert [len(o) for o in out] == [7, 6]
    (eng,) = server._engines.values()
    assert eng.stats().admitted == 2


def test_temperature_reproducible_across_calls(fleet):
    _, server = server_of(fleet, n=1)
    reqs = [tserve.Request(p, "t0") for p in prompts_of(fleet, 15, (5, 7))]
    out1 = server.serve(reqs, gen_len=3, max_len=12, temperature=0.9, seed=5)
    out2 = server.serve(reqs, gen_len=3, max_len=12, temperature=0.9, seed=5)
    for a, b in zip(out1, out2):
        assert a.tolist() == b.tolist()
    (eng,) = server._engines.values()
    assert eng.stats().admitted == 4 and eng.temperature == 0.9


def test_uniform_lengths_forced_through_engine_match_static(fleet):
    _, server = server_of(fleet)
    reqs = [tserve.Request(p, f"t{i % 2}")
            for i, p in enumerate(prompts_of(fleet, 11, (6, 6, 6)))]
    static = server.serve(reqs, gen_len=3, max_len=10).numpy()
    cont = server.serve(reqs, gen_len=3, max_len=10, static=False)
    for row, srow in zip(cont, static):
        assert row.tolist() == srow.tolist()


def test_speculative_k_routes_to_the_engine(fleet):
    cache, server = server_of(fleet)
    reqs = [tserve.Request(p, f"t{i % 2}")
            for i, p in enumerate(prompts_of(fleet, 17, (6, 6, 6)))]
    static = server.serve(reqs, gen_len=4, max_len=12).numpy()
    spec = server.serve(reqs, gen_len=4, max_len=12, speculative_k=2)
    for row, srow in zip(spec, static):
        assert row.tolist() == srow.tolist()
    (eng,) = server._engines.values()
    assert eng.speculative_k == 2 and eng.stats().verify_steps > 0
    assert eng.step_signatures()["verify"]
    with pytest.raises(ValueError, match="speculative_k requires"):
        server.serve(reqs, gen_len=4, max_len=12, static=True,
                     speculative_k=2)


def test_engine_cache_holds_two_engines(fleet):
    _, server = server_of(fleet, n=1, engine_slots=2)
    reqs = [tserve.Request(p, "t0") for p in prompts_of(fleet, 18, (4, 5))]
    for max_len in (9, 10, 11):
        server.serve(reqs, gen_len=2, max_len=max_len)
    assert list(server._engines) == [(2, 10), (2, 11)]
    assert all(isinstance(e, DecodeEngine) for e in server._engines.values())
