"""Fleet grouping in the port's ``DecodeEngine`` against the reference.

qwen2-7b SMOKE (fp32) from the reference's ``build_state``, with tenant
adapter trees whose B and m are perturbed with numpy (seed-built trees
have B = 0, so every tenant would compute the base model and a row served
under the wrong tenant would pass), registered with each package's
``AdapterStateCache`` through the bridge. The same requests go through
the reference's engine and the port's:

  - the committed ``BENCH_serve.json`` ``fleet`` trace (12 requests, 5
    tenants, 3 slots): the counters of ``fleet.schedule_model``, its four
    static ``signature_keys`` and the dynamic engine's one, ``stats()``
    and ``CacheStats`` equal to the reference's, and equal streams;
  - the reference's fleet cases: dynamic == static == each request served
    alone, one signature under churn, dynamic + speculative + paged,
    ``max_active_per_adapter``, and no norm work in the dynamic decode.

Tolerances (fp32): tokens equal everywhere. Logits: the port's dynamic
and static engines and each request served alone within 2e-6 of max
|logit|; the port against the reference within 1e-5 of max |logit| (the
engine steps' tolerance). Inside the port the paths reduce in different
orders (the dynamic compose's all-K products, the static one's per-group
products, the single request's batch of one), and one decode step agrees
within 1e-6 of max (``test_torch_multitenant.py``); over a stream the
differences ride along in the K/V cache, and on the committed trace the
largest gaps are 1.31e-6 (dynamic vs static), 1.23e-6 (dynamic vs alone)
and 0.96e-6 (static vs alone) of max |logit|.
"""
from __future__ import annotations

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_config as jget_config
from repro.core.config import DoRAConfig as JConfig
from repro.launch.engine import DecodeEngine as JEngine
from repro.launch.steps import StepConfig as JStep
from repro.launch.train import build_state as jbuild_state
from repro_torch import core as tcore
from repro_torch.bridge import flatten_paths, tree_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import adapter as tadapter
from repro_torch.core.config import FORCE_TIER_ENV, DoRAConfig
from repro_torch.kernels import factored_norm as tk_norm
from repro_torch.kernels import ops as tk_ops
from repro_torch.launch import serve as tserve
from repro_torch.launch.engine import DecodeEngine
from repro_torch.launch.steps import StepConfig

ROOT = Path(__file__).resolve().parents[1]
RANK, ALPHA = 4, 8.0
JDCFG = JConfig(rank=RANK, alpha=ALPHA, mode="eager")
TDCFG = DoRAConfig(rank=RANK, alpha=ALPHA, mode="auto")
ARCH = "qwen2-7b"
N_TENANTS = 5
ML = 14
INSIDE, ACROSS = 2e-6, 1e-5


@pytest.fixture(autouse=True)
def _no_forced_tier(monkeypatch):
    for name in ("REPRO_FORCE_TIER", "REPRO_DORA_MODE", "REPRO_DORA_FUSED",
                 FORCE_TIER_ENV):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: under several test workers, each worker's
    default pool oversubscribes the machine and every small op waits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturb(adapters, seed):
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


class Fleet:
    """The model and the tenants of both packages: the reference's params
    and perturbed tenant trees (numpy), their bridged port copies, and
    builders of caches and engines over them."""

    def __init__(self):
        self.jm = jget_config(ARCH, smoke=True)
        params, _, _ = jbuild_state(self.jm, JDCFG, 0)
        self.params = jax.tree_util.tree_map(np.array, params)
        self.tenants = []
        for t in range(N_TENANTS):
            _, ad, _ = jbuild_state(self.jm, JDCFG, 10 + t)
            self.tenants.append(perturb(
                jax.tree_util.tree_map(np.array, ad), 100 + t))
        self.tm = get_config(ARCH, smoke=True)
        self.tparams = tree_from_numpy(self.params)
        self.jscfg = JStep(dora=JDCFG)
        self.scfg = StepConfig(dora=TDCFG)

    def variant(self, t: int, seed: int):
        """Tenant t's tree perturbed again from ``seed`` (a new version)."""
        return perturb(jax.tree_util.tree_map(np.copy, self.tenants[t]),
                       seed)

    def ref_cache(self, n=N_TENANTS, **kw):
        cache = jcore.AdapterStateCache.for_serving(self.jm, self.jscfg, **kw)
        for t in range(n):
            cache.register(f"t{t}", self.tenants[t])
        return cache

    def port_cache(self, n=N_TENANTS, **kw):
        cache = tcore.AdapterStateCache.for_serving(self.tm, self.scfg,
                                                    device="cpu", **kw)
        for t in range(n):
            cache.register(f"t{t}", tree_from_numpy(self.tenants[t]))
        return cache

    def ref_engine(self, cache, **kw):
        return JEngine(self.jm, self.jscfg, self.params, adapter_cache=cache,
                       **kw)

    def port_engine(self, cache, **kw):
        return DecodeEngine(self.tm, self.scfg, self.tparams,
                            adapter_cache=cache, device="cpu", **kw)

    def alone(self, cache, prompt, gen_len, adapter, max_len=ML):
        """The oracle: the request served alone through the port's
        ``generate`` on the cached state: (tokens, per-token logits)."""
        toks, logits = tserve.generate(
            self.tm, self.tparams, cache.current_handle(adapter), self.scfg,
            np.asarray(prompt)[None], gen_len=gen_len, max_len=max_len,
            adapter_cache=cache, return_logits=True, device="cpu")
        return (toks[0, len(prompt):].tolist(),
                [lg[0].numpy().astype(np.float64) for lg in logits])


@pytest.fixture(scope="module")
def fleet():
    return Fleet()


def capture_logits(engine) -> dict:
    """Record every sampled row's logits by (key_id, tokens sampled
    before it): both engines sample through ``_sample_rows`` with these
    keys, so the record is comparable across engines and packages."""
    seen: dict = {}
    sample = engine._sample_rows

    def recorded(rows, keys):
        for row, key in zip(rows, keys):
            seen[tuple(int(k) for k in key)] = np.asarray(row, np.float64)
        return sample(rows, keys)
    engine._sample_rows = recorded
    return seen


def rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def assert_logits_close(got: dict, want: dict, tol: float):
    assert got.keys() == want.keys()
    worst = max(rel(got[k], want[k]) for k in want)
    assert worst <= tol, f"logits {worst:.2e} of max apart (> {tol})"


# ---------------------------------------------------------------------------
# The committed fleet trace.
# ---------------------------------------------------------------------------

def fleet_trace():
    """``BENCH_serve.json``'s ``fleet`` section: (arrival_step, prompt_len,
    gen_len, tenant) per request as ``make_fleet_trace`` draws them, the
    engine kwargs, and the committed schedule model."""
    sec = json.loads((ROOT / "BENCH_serve.json").read_text())["fleet"]
    tp = sec["trace"]
    rng = np.random.default_rng(tp["seed"])
    t, trace = 0.0, []
    for _ in range(tp["n_requests"]):
        t += rng.exponential(tp["mean_interarrival"])
        trace.append([int(t), tp["prompt_len"],
                      int(rng.choice(tp["gen_lens"]))])
    tenants = np.random.default_rng(tp["seed"] + 1)
    for r in trace:
        r.append(int(tenants.integers(tp["tenants"])))
    return trace, {"slots": tp["slots"], "max_len": tp["max_len"]}, \
        sec["schedule_model"]


def drive(engine, trace, prompts) -> dict:
    """Submit each request as its arrival step comes due (adapter
    ``t<tenant>``, key_id its index) and tick once per step; returns
    {request_id: [token, ...]}."""
    streams: dict = {}

    def on_token(rid, tok):
        streams.setdefault(rid, []).append(int(tok))

    i, step = 0, 0
    while i < len(trace) or engine.has_work():
        while i < len(trace) and trace[i][0] <= step:
            engine.submit(prompts[i], adapter=f"t{trace[i][3]}",
                          max_new_tokens=trace[i][2], key_id=i)
            i += 1
        engine.step(on_token)
        step += 1
    return streams


@pytest.fixture(scope="module")
def fleet_runs(fleet):
    """The committed trace through the dynamic and static engines of both
    packages, each with a fresh cache."""
    trace, kw, model = fleet_trace()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, fleet.tm.vocab_size, r[1], dtype=np.int32)
               for r in trace]
    runs = {}
    for pkg in ("port", "ref"):
        for form in ("dynamic", "static"):
            cache = (fleet.port_cache() if pkg == "port"
                     else fleet.ref_cache())
            engine = getattr(fleet, f"{pkg}_engine")(
                cache, dynamic_grouping=form == "dynamic", **kw)
            logits = capture_logits(engine)
            streams = drive(engine, trace, prompts)
            runs[pkg, form] = {"engine": engine, "cache": cache,
                               "streams": streams, "logits": logits}
    return trace, prompts, model, runs


@pytest.mark.parametrize("form", ["dynamic", "static"])
def test_fleet_trace_counters_equal_schedule_model(fleet_runs, form):
    _, _, model, runs = fleet_runs
    st = runs["port", form]["engine"].stats()
    for field in ("steps", "decode_steps", "prefills", "generated_tokens",
                  "slot_steps"):
        assert getattr(st, field) == model[field], field
    assert (st.steps, st.decode_steps, st.prefills, st.generated_tokens,
            st.slot_steps) == (42, 36, 12, 88, 76)
    assert st.mean_occupancy == pytest.approx(model["mean_occupancy"])


def test_fleet_trace_signatures(fleet_runs):
    """The static engine decodes under the four committed
    ``signature_keys``, the dynamic one under ``"dynamic"`` alone; each
    count is the reference's signature set, and the steps add up."""
    _, _, model, runs = fleet_runs
    static = runs["port", "static"]["engine"].step_signatures()
    dynamic = runs["port", "dynamic"]["engine"].step_signatures()
    assert sorted(static["decode"]) == model["signature_keys"]
    assert len(static["decode"]) == model["static_signatures"] == 4
    assert list(dynamic["decode"]) == ["dynamic"]
    assert dynamic["decode"]["dynamic"] == model["decode_steps"]
    assert sum(static["decode"].values()) == model["decode_steps"]
    assert static["verify"] == dynamic["verify"] == {}
    ref_static = runs["ref", "static"]["engine"].compile_counts()["decode"]
    assert sorted(str(k) for k in ref_static) == sorted(static["decode"])
    assert list(runs["ref", "dynamic"]["engine"].compile_counts()[
        "decode"]) == ["dynamic"]


@pytest.mark.parametrize("form", ["dynamic", "static"])
def test_fleet_trace_stats_equal_reference(fleet_runs, form):
    _, _, _, runs = fleet_runs
    port, ref = runs["port", form], runs["ref", form]
    assert port["engine"].stats().as_dict() == ref["engine"].stats().as_dict()
    assert port["cache"].stats().as_dict() == ref["cache"].stats().as_dict()
    st = port["engine"].stats()
    if form == "dynamic":
        assert 0 < st.stack_inserts <= st.admitted
        assert port["engine"].device_steps()["adapter_insert"] == \
            st.stack_inserts
    else:
        assert st.stack_inserts == 0


def test_fleet_trace_streams_equal(fleet_runs):
    """Dynamic == static == the reference's streams; logits 1e-6 of max
    apart inside the port and 1e-5 from the reference's; the tenants
    really differ (not every request streams the same tokens)."""
    _, _, _, runs = fleet_runs
    dyn = runs["port", "dynamic"]
    assert dyn["streams"] == runs["port", "static"]["streams"]
    assert dyn["streams"] == runs["ref", "dynamic"]["streams"]
    assert dyn["streams"] == runs["ref", "static"]["streams"]
    assert_logits_close(dyn["logits"], runs["port", "static"]["logits"],
                        INSIDE)
    assert_logits_close(dyn["logits"], runs["ref", "dynamic"]["logits"],
                        ACROSS)
    assert len({tuple(v) for v in dyn["streams"].values()}) > 1


def test_fleet_trace_each_request_alone(fleet, fleet_runs):
    """Each request of the trace served alone through ``generate`` gives
    the dynamic engine's tokens, logits 1e-6 of max apart."""
    trace, prompts, _, runs = fleet_runs
    dyn = runs["port", "dynamic"]
    cache = fleet.port_cache()
    for i, r in enumerate(trace):
        toks, logits = fleet.alone(cache, prompts[i], r[2], f"t{r[3]}",
                                   max_len=r[1] + r[2])
        assert toks == dyn["streams"][i], i
        for n, lg in enumerate(logits):
            assert rel(dyn["logits"][i, n], lg) <= INSIDE, (i, n)


# ---------------------------------------------------------------------------
# The reference's fleet cases.
# ---------------------------------------------------------------------------

def small_trace(vocab, n=7, tenants=3, seed=0):
    """The reference's ``TestFleetServing._trace``: (prompt, budget,
    adapter id) per request."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, 4 + (i % 3), dtype=np.int32),
             3 + (i % 3), f"t{i % tenants}") for i in range(n)]


def run_all(engine, reqs) -> dict:
    for i, (p, g, a) in enumerate(reqs):
        engine.submit(p, adapter=a, max_new_tokens=g, key_id=i)
    return {r.request_id: r.tokens.tolist() for r in engine.run()}


def test_dynamic_streams_match_static_reference_and_alone(fleet):
    reqs = small_trace(fleet.tm.vocab_size)
    cache = fleet.port_cache(3)
    dyn_eng = fleet.port_engine(cache, slots=3, max_len=ML,
                                dynamic_grouping=True)
    dyn_logits = capture_logits(dyn_eng)
    dyn = run_all(dyn_eng, reqs)
    sta_eng = fleet.port_engine(cache, slots=3, max_len=ML)
    sta_logits = capture_logits(sta_eng)
    assert run_all(sta_eng, reqs) == dyn
    assert_logits_close(dyn_logits, sta_logits, INSIDE)
    ref = run_all(fleet.ref_engine(fleet.ref_cache(3), slots=3, max_len=ML,
                                   dynamic_grouping=True), reqs)
    assert ref == dyn
    for i, (p, g, a) in enumerate(reqs):
        toks, logits = fleet.alone(cache, p, g, a)
        assert toks == dyn[i], i
        for n, lg in enumerate(logits):
            assert rel(dyn_logits[i, n], lg) <= INSIDE, (i, n)
    assert dyn_eng.step_signatures()["decode"].keys() == {"dynamic"}
    assert dyn_eng.device_steps()["adapter_insert"] == \
        dyn_eng.stats().stack_inserts


@pytest.mark.parametrize("seed", [7, 11])
def test_signatures_are_churn_invariant(fleet, seed):
    """N adapters > slots, submissions, version bumps and invalidations
    between waves, the same in both packages: the port's dynamic engine
    decodes under ``"dynamic"`` alone, finishes every request once with
    the reference's tokens and ``stats()``, and drains its stack
    positions with the slot table."""
    tenants = 4
    engines = {"port": fleet.port_engine(fleet.port_cache(tenants), slots=2,
                                         max_len=ML, dynamic_grouping=True),
               "ref": fleet.ref_engine(fleet.ref_cache(tenants), slots=2,
                                       max_len=ML, dynamic_grouping=True)}
    out = {}
    for pkg, eng in engines.items():
        cache = eng.adapter_cache
        rng = np.random.default_rng(seed)
        submitted, finished = [], {}
        for wave in range(3):
            for _ in range(4):
                t = int(rng.integers(tenants))
                p = rng.integers(0, fleet.tm.vocab_size,
                                 int(rng.integers(3, 7)), dtype=np.int32)
                submitted.append(eng.submit(p, adapter=f"t{t}",
                                            max_new_tokens=int(
                                                rng.integers(2, 5))))
            for _ in range(int(rng.integers(1, 6))):
                if eng.has_work():
                    eng.step()
            finished.update({r.request_id: r.tokens.tolist()
                             for r in eng.pop_results()})
            bump = int(rng.integers(tenants))
            new = fleet.variant(bump, 90 + wave)
            cache.update(f"t{bump}", new if pkg == "ref"
                         else tree_from_numpy(new))
            cache.invalidate(f"t{int(rng.integers(tenants))}")
            if pkg == "port":
                assert set(eng.step_signatures()["decode"]) <= {"dynamic"}
        finished.update({r.request_id: r.tokens.tolist()
                         for r in eng.run()})
        assert sorted(finished) == sorted(submitted)
        out[pkg] = finished
    port = engines["port"]
    assert out["port"] == out["ref"]
    assert port.stats().as_dict() == engines["ref"].stats().as_dict()
    assert list(port.step_signatures()["decode"]) == ["dynamic"]
    assert port.stats().stack_inserts > 0
    assert port.device_steps()["adapter_insert"] == port.stats().stack_inserts
    assert len(port._dyn_free) == port.slots and not port._dyn_pos


def test_dynamic_speculative_and_paged_equal_plain(fleet):
    """Dynamic grouping under speculation (k = 2, the verify grouped under
    ``"dynamic"``) and on a paged cache: the plain static streams, and
    the reference's."""
    reqs = small_trace(fleet.tm.vocab_size)
    cache = fleet.port_cache(3)
    plain = run_all(fleet.port_engine(cache, slots=3, max_len=ML), reqs)
    spec = fleet.port_engine(cache, slots=3, max_len=ML,
                             dynamic_grouping=True, speculative_k=2)
    assert run_all(spec, reqs) == plain
    assert spec.stats().verify_steps > 0
    assert spec.step_signatures()["verify"].keys() == {"('dynamic', 3)"}
    paged = fleet.port_engine(cache, slots=3, max_len=ML,
                              dynamic_grouping=True, paged=True)
    assert run_all(paged, reqs) == plain
    assert paged.pool_stats()["used_blocks"] == 0
    ref = fleet.ref_engine(fleet.ref_cache(3), slots=3, max_len=ML,
                           dynamic_grouping=True, speculative_k=2)
    assert run_all(ref, reqs) == plain
    assert spec.stats().as_dict() == ref.stats().as_dict()


def test_max_active_per_adapter_prevents_starvation(fleet):
    """A hot tenant's burst holds one slot at a time; the other tenant
    admits and finishes before the burst drains, nothing is preempted,
    and the schedule is the reference's."""
    out = {}
    for pkg in ("port", "ref"):
        cache = getattr(fleet, f"{pkg}_cache")(2)
        eng = getattr(fleet, f"{pkg}_engine")(cache, slots=3, max_len=ML,
                                              max_active_per_adapter=1)
        p = np.random.default_rng(3).integers(0, fleet.tm.vocab_size, 4,
                                              dtype=np.int32)
        hot = [eng.submit(p, adapter="t0", max_new_tokens=4)
               for _ in range(5)]
        other = eng.submit(p, adapter="t1", max_new_tokens=4)
        max_hot = 0
        while eng.has_work():
            eng.step()
            max_hot = max(max_hot, sum(
                1 for s in eng._slots
                if s.occupied and s.handle.adapter_id == "t0"))
        results = {r.request_id: r for r in eng.pop_results()}
        assert max_hot == 1
        assert len(results) == 6
        assert all(r.finish_reason == "length" for r in results.values())
        assert results[other].finished_step < max(
            results[rid].finished_step for rid in hot)
        assert eng.stats().preemptions == 0
        out[pkg] = {rid: (r.admitted_step, r.finished_step, r.tokens.tolist())
                    for rid, r in results.items()}
    assert out["port"] == out["ref"]


def test_rate_limited_requests_keep_queue_order(fleet):
    cache = fleet.port_cache(2)
    eng = fleet.port_engine(cache, slots=2, max_len=ML,
                            max_active_per_adapter=1)
    p = np.random.default_rng(4).integers(0, fleet.tm.vocab_size, 4,
                                          dtype=np.int32)
    rids = [eng.submit(p, adapter="t0", max_new_tokens=3) for _ in range(3)]
    rids.append(eng.submit(p, adapter="t1", max_new_tokens=3,
                           priority=1))
    results = {r.request_id: r for r in eng.run()}
    admits = [results[r].admitted_step for r in rids[:3]]
    assert admits == sorted(admits) and len(set(admits)) == 3
    # the eligible t1 request outranks and admits at once; a held t0
    # request never preempts
    assert results[rids[3]].admitted_step == 0
    assert eng.stats().preemptions == 0


def test_dynamic_requires_adapter_cache(fleet):
    cache = fleet.port_cache(1)
    fixed = cache.get_state(fleet.tparams, cache.current_handle("t0"))
    with pytest.raises(ValueError, match="dynamic_grouping"):
        DecodeEngine(fleet.tm, fleet.scfg, fleet.tparams, slots=2,
                     max_len=10, adapters=fixed, dynamic_grouping=True,
                     device="cpu")
    for bad in (0, -1):
        with pytest.raises(ValueError, match="max_active_per_adapter"):
            fleet.port_engine(cache, slots=2, max_len=10,
                              max_active_per_adapter=bad)


def test_dynamic_decode_runs_no_norm(fleet, monkeypatch):
    """In forced kernel mode the norm runs once per adapted module at each
    cache miss (the precompute: ``ops.fused_norm``, then K1's plain
    version on the CPU, where the norm plan fuses) and never in a dynamic
    decode or verify tick."""
    calls = {"compute_weight_norm": 0, "fused_norm": 0,
             "norm_terms_plain": 0}
    for mod, name in ((tadapter, "compute_weight_norm"),
                      (tk_ops, "fused_norm"), (tk_norm, "norm_terms_plain")):
        def counted(*a, _orig=getattr(mod, name), _key=name, **k):
            calls[_key] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    scfg = StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA, mode="fused"))
    cache = tcore.AdapterStateCache.for_serving(fleet.tm, scfg, device="cpu")
    for t in range(3):
        cache.register(f"t{t}", tree_from_numpy(fleet.tenants[t]))
    eng = DecodeEngine(fleet.tm, scfg, fleet.tparams, slots=3, max_len=ML,
                       adapter_cache=cache, dynamic_grouping=True,
                       speculative_k=2, device="cpu")
    for i, (p, g, a) in enumerate(small_trace(fleet.tm.vocab_size)):
        eng.submit(p, adapter=a, max_new_tokens=g, key_id=i)
    n_adapted = 7 * fleet.tm.num_layers
    assert cache.stats().misses == 3
    # every adapted module's norm once a miss; K1 (its plain version
    # here) where the norm plan fuses, at the same modules each time
    assert calls["compute_weight_norm"] == 3 * n_adapted
    assert calls["fused_norm"] == calls["norm_terms_plain"] > 0
    assert calls["fused_norm"] % 3 == 0
    want = dict(calls)
    eng.run()
    assert eng.device_steps()["verify"] > 0
    plain = DecodeEngine(fleet.tm, scfg, fleet.tparams, slots=3, max_len=ML,
                         adapter_cache=cache, dynamic_grouping=True,
                         device="cpu")
    run_all(plain, small_trace(fleet.tm.vocab_size))
    assert plain.device_steps()["decode"] > 0
    assert calls == want and cache.stats().misses == 3
    # the stack holds only what the grouped compose reads
    leaves = flatten_paths(eng._dyn_stack)
    assert {n.rsplit("/", 1)[1] for n in leaves} == {"A", "g", "gsB"}
    assert all(t.shape[1] == eng.slots for t in leaves.values())
