"""The port's observability (``repro_torch/obs``) against the reference's.

  - the ring, the metric primitives, the exporters (JSONL, Chrome trace,
    Prometheus text, JSON) and the derived latencies: each of the
    reference's cases written once and run on both packages' copies;
  - the traced engine: over the reference's ``_drive`` variants (clean,
    ``nan@3`` with a deadline, speculative k = 2, paged) the port's event
    stream equals the reference's event by event (name, tick, request id,
    slot and data; all but the wall time), tracing on equals tracing off
    (streams, ``stats()``, ``device_steps()``, ``step_signatures()``),
    and every event is made of host scalars (``json.dumps`` with no
    ``default=``);
  - the committed ``BENCH_serve.json`` ``obs`` trace: the latencies derived
    from the port's trace equal ``obs.lifecycle_model`` exactly, with 136
    events and none dropped;
  - the adapter cache's ``spill`` and ``reload`` events on a traced
    engine's trace, and ``engine_metrics`` with the reference's metric
    names (``device_steps_total`` standing for ``compiles_total``).

The model is qwen2-7b SMOKE in fp32 from the reference's ``build_state``,
carried to the port by the bridge; one tenant, ``t0``.
"""
from __future__ import annotations

import json
import math
from collections import Counter as Tally
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as tobs
from repro import core as jcore
from repro.configs import get_config as jget_config
from repro.core.config import DoRAConfig as JConfig
from repro.launch.engine import DecodeEngine as JEngine
from repro.launch.faults import FaultPlan as JPlan
from repro.launch.steps import StepConfig as JStep
from repro.launch.train import build_state as jbuild_state
from repro_torch import core as tcore
from repro_torch.bridge import tree_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.config import FORCE_TIER_ENV, DoRAConfig
from repro_torch.launch.engine import FINISH_REASONS, DecodeEngine
from repro_torch.launch.faults import FaultPlan
from repro_torch.launch.steps import StepConfig, make_precompute_step

ROOT = Path(__file__).resolve().parents[1]
RANK, ALPHA = 4, 8.0
ARCH = "qwen2-7b"
ML = 14
_REQS = [(5, 4), (6, 5), (4, 3), (5, 4)]     # (prompt_len, budget)
VARIANTS = ["clean", "faulty", "spec", "paged"]


@pytest.fixture(autouse=True)
def _no_forced_tier(monkeypatch):
    for name in ("REPRO_FORCE_TIER", "REPRO_DORA_MODE", "REPRO_DORA_FUSED",
                 FORCE_TIER_ENV):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["reference", "port"])
def obs(request):
    """The package whose copy of ``obs`` a case runs on."""
    return jobs if request.param == "reference" else tobs


class _FakeClock:
    """Deterministic monotone clock for exporter/latency tests."""

    def __init__(self, dt: float = 0.5):
        self.t = 0.0
        self.dt = dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


# ---------------------------------------------------------------------------
# The ring, the primitives, the exporters, the latencies (both copies).
# ---------------------------------------------------------------------------

def test_ring_bounds_and_counts_overflow(obs):
    rec = obs.TraceRecorder(capacity=4, clock=_FakeClock())
    for i in range(10):
        rec.emit("token", tick=i, request_id=0, token=i)
    assert len(rec) == 4 and rec.emitted == 10 and rec.dropped == 6
    assert [e.tick for e in rec] == [6, 7, 8, 9]
    with pytest.raises(ValueError):
        obs.TraceRecorder(capacity=0)


def test_ring_filters_and_request_ids(obs):
    rec = obs.TraceRecorder(clock=_FakeClock())
    rec.emit("submitted", tick=0, request_id=1)
    rec.emit("submitted", tick=0, request_id=2)
    rec.emit("terminal", tick=3, request_id=1, reason="length")
    rec.emit("fault", tick=2, kind="nan")
    assert rec.request_ids() == [1, 2]
    assert len(rec.events("submitted")) == 2
    assert len(rec.events(request_id=1)) == 2
    assert rec.events("terminal", request_id=1)[0].data["reason"] == "length"
    assert rec.events("terminal", request_id=2) == []
    ws = [e.t_wall for e in rec]
    assert ws == sorted(ws) and ws[0] >= 0.0


def test_taxonomy_is_the_reference(obs):
    assert set(obs.LIFECYCLE_EVENTS) & set(obs.AUX_EVENTS) == set()
    assert obs.EVENT_NAMES == obs.LIFECYCLE_EVENTS + obs.AUX_EVENTS
    assert obs.EVENT_NAMES == jobs.EVENT_NAMES
    assert obs.TICK_BUCKETS == jobs.TICK_BUCKETS
    assert obs.SECONDS_BUCKETS == jobs.SECONDS_BUCKETS
    assert len(FINISH_REASONS) == 6
    assert obs.monotonic is __import__("time").perf_counter


def test_primitives(obs):
    h = obs.Histogram(buckets=(1, 2, 4))
    for v in (1, 1.5, 4, 5):
        h.observe(v)
    assert h.cumulative() == [(1.0, 1), (2.0, 2), (4.0, 3), (math.inf, 4)]
    assert h.count == 4 and h.sum == pytest.approx(11.5)
    for bad in ((2, 1), ()):
        with pytest.raises(ValueError):
            obs.Histogram(buckets=bad)
    c = obs.Counter()
    c.inc(2)
    with pytest.raises(ValueError):
        c.inc(-1)
    assert c.value == 2
    xs = [1, 2, 3, 4]
    assert (obs.percentile(xs, 50), obs.percentile(xs, 100),
            obs.percentile(xs, 0), obs.percentile([], 50)) == (2, 4, 1, 0.0)
    with pytest.raises(ValueError):
        obs.percentile(xs, 101)
    reg = obs.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(ValueError):
        reg.gauge("x")
    reg.counter("n", labels={"k": "a"}).inc(1)
    reg.counter("n", labels={"k": "b"}).inc(2)
    assert reg.counter("n", labels={"k": "a"}).value == 1
    assert reg.counter("n", labels={"k": "b"}).value == 2


def _registry(obs):
    reg = obs.MetricsRegistry()
    reg.counter("reqs_total", "requests").inc(7)
    reg.gauge("occupancy", "busy slots").set(1.5)
    h = reg.histogram("wait_ticks", "queue wait", buckets=(1, 2, 4))
    for v in (1, 3, 9):
        h.observe(v)
    reg.counter("finished_total", labels={"reason": "eos"}).inc(2)
    return reg


def test_prometheus_and_json_exporters(obs, tmp_path):
    reg = _registry(obs)
    text = reg.to_prometheus(str(tmp_path / "m.prom"))
    assert (tmp_path / "m.prom").read_text() == text
    assert text == _registry(jobs).to_prometheus()
    parsed = obs.parse_prometheus(text)
    assert parsed["repro_reqs_total"] == 7
    assert parsed["repro_occupancy"] == 1.5
    assert parsed['repro_finished_total{reason="eos"}'] == 2
    assert parsed['repro_wait_ticks_bucket{le="1"}'] == 1
    assert parsed['repro_wait_ticks_bucket{le="4"}'] == 2
    assert parsed['repro_wait_ticks_bucket{le="+Inf"}'] == 3
    assert (parsed["repro_wait_ticks_sum"],
            parsed["repro_wait_ticks_count"]) == (13, 3)
    assert "# TYPE repro_wait_ticks histogram" in text
    assert "# HELP repro_reqs_total requests" in text
    snap = reg.to_json(str(tmp_path / "m.json"))
    assert json.loads((tmp_path / "m.json").read_text()) == \
        json.loads(json.dumps(snap))
    assert snap["reqs_total"]["kind"] == "counter"
    assert snap["wait_ticks"]["samples"][0]["count"] == 3
    assert snap["wait_ticks"]["samples"][0]["buckets"][-1] == ["inf", 3]


def test_jsonl_round_trip(obs, tmp_path):
    rec = obs.TraceRecorder(clock=_FakeClock())
    rec.emit("submitted", tick=0, request_id=0, prompt_len=5)
    rec.emit("terminal", tick=4, request_id=0, slot=1, reason="length",
             n_tokens=4)
    text = rec.to_jsonl(str(tmp_path / "t.jsonl"))
    assert (tmp_path / "t.jsonl").read_text() == text
    parsed = [json.loads(line) for line in text.splitlines()]
    assert parsed == [e.as_dict() for e in rec]
    assert parsed[1]["data"]["reason"] == "length"


def _lifecycle(rec):
    rec.emit("submitted", tick=0, request_id=0, prompt_len=5)
    rec.emit("queued", tick=0, request_id=0, depth=1)
    rec.emit("admitted", tick=0, request_id=0, slot=0, prompt_len=5)
    rec.emit("first_token", tick=1, request_id=0, slot=0, token=7)
    rec.emit("token", tick=2, request_id=0, slot=0, token=9)
    rec.emit("preempted", tick=3, request_id=0, slot=0, n_generated=2)
    rec.emit("admitted", tick=5, request_id=0, slot=1, prompt_len=7)
    rec.emit("resumed", tick=5, request_id=0, slot=1, attempt=1)
    rec.emit("terminal", tick=7, request_id=0, slot=1, reason="length",
             n_tokens=4)
    rec.emit("fault", tick=6, kind="nan")
    return rec


def test_chrome_trace_spans(obs, tmp_path):
    doc = _lifecycle(obs.TraceRecorder(clock=_FakeClock())).to_chrome_trace(
        str(tmp_path / "t.json"))
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads(json.dumps(doc))
    ref = _lifecycle(jobs.TraceRecorder(clock=_FakeClock())).to_chrome_trace()
    names = [e for e in doc["traceEvents"] if e.get("name") != "process_name"]
    assert names == [e for e in ref["traceEvents"]
                     if e.get("name") != "process_name"]
    evs = doc["traceEvents"]
    assert all(e["ph"] in ("M", "X", "i") for e in evs)
    spans = [e for e in evs if e["ph"] == "X"]
    assert all(e["dur"] >= 0.0 for e in spans)
    queue = [e for e in spans if e["name"].startswith("queued")]
    resid = [e for e in spans if e["name"] == "r0"]
    assert len(queue) == 2 and len(resid) == 2
    assert sorted(e["tid"] for e in resid) == [0, 1]
    assert [q["args"]["ticks"] for q in queue] == [0, 2]
    inst = [e for e in evs if e["ph"] == "i" and e["name"] == "fault"]
    assert inst and inst[0]["tid"] > max(e["tid"] for e in resid)
    assert doc["otherData"]["emitted"] == 10
    rec = obs.TraceRecorder(clock=_FakeClock())
    rec.emit("submitted", tick=0, request_id=0)
    rec.emit("admitted", tick=0, request_id=0, slot=0)
    rec.emit("token", tick=1, request_id=0, slot=0, token=3)
    open_spans = [e for e in rec.to_chrome_trace()["traceEvents"]
                  if e["ph"] == "X" and e["name"].endswith("(open)")]
    assert len(open_spans) == 1 and open_spans[0]["dur"] >= 0.0


def _latency_rec(obs):
    rec = obs.TraceRecorder(clock=_FakeClock(dt=1.0))
    rec.emit("submitted", tick=0, request_id=0)
    rec.emit("admitted", tick=2, request_id=0, slot=0)
    rec.emit("first_token", tick=3, request_id=0, slot=0, token=1)
    rec.emit("token", tick=4, request_id=0, slot=0, token=2)
    rec.emit("token", tick=6, request_id=0, slot=0, token=3)
    rec.emit("terminal", tick=6, request_id=0, slot=0, reason="length",
             n_tokens=3)
    rec.emit("submitted", tick=1, request_id=1)
    rec.emit("terminal", tick=5, request_id=1, reason="timeout", queued=True)
    return rec


def test_latencies(obs):
    lat = obs.lifecycle_latencies(_latency_rec(obs))
    assert lat == jobs.lifecycle_latencies(_latency_rec(jobs))
    r0, r1 = lat[0], lat[1]
    assert (r0["queue_wait_ticks"], r0["ttft_ticks"],
            r0["admit_to_retire_ticks"], r0["itl_ticks"]) == (2, 3, 4, [1, 2])
    assert r0["reason"] == "length" and r0["ttft_s"] == pytest.approx(2.0)
    assert r1["admitted_tick"] is None and r1["queue_wait_ticks"] is None
    assert r1["ttft_ticks"] is None and r1["itl_ticks"] == []
    assert r1["reason"] == "timeout"
    parsed = obs.parse_prometheus(
        obs.latency_metrics(_latency_rec(obs)).to_prometheus())
    assert parsed["repro_ttft_ticks_count"] == 1
    assert parsed["repro_itl_ticks_count"] == 2
    assert parsed['repro_requests_finished_total{reason="length"}'] == 1
    assert parsed['repro_requests_finished_total{reason="timeout"}'] == 1
    assert parsed["repro_trace_events_emitted_total"] == 8
    assert parsed["repro_trace_events_dropped_total"] == 0


# ---------------------------------------------------------------------------
# The traced engine against the reference's.
# ---------------------------------------------------------------------------

class Model:
    """qwen2-7b SMOKE and one tenant (the reference's ``_setup``), in
    both packages."""

    def __init__(self):
        self.jdcfg = JConfig(rank=RANK, alpha=ALPHA, mode="eager")
        self.jm = jget_config(ARCH, smoke=True)
        params, _, _ = jbuild_state(self.jm, self.jdcfg, 0)
        self.params = jax.tree_util.tree_map(np.array, params)
        _, ad, _ = jbuild_state(self.jm, self.jdcfg, 10)
        self.tenant = jax.tree_util.tree_map(np.array, ad)
        self.tm = get_config(ARCH, smoke=True)
        self.scfg = StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA,
                                               mode="auto"))
        self.tparams = tree_from_numpy(self.params)
        rng = np.random.default_rng(0)
        self.prompts = [rng.integers(0, self.tm.vocab_size, P,
                                     dtype=np.int32) for P, _ in _REQS]

    def cache(self, pkg, **kw):
        if pkg == "ref":
            cache = jcore.AdapterStateCache.for_serving(
                self.jm, JStep(dora=self.jdcfg), **kw)
            cache.register("t0", self.tenant)
        else:
            cache = tcore.AdapterStateCache.for_serving(
                self.tm, self.scfg, device="cpu", **kw)
            cache.register("t0", tree_from_numpy(self.tenant))
        return cache

    def engine(self, pkg, cache, **kw):
        if pkg == "ref":
            return JEngine(self.jm, JStep(dora=self.jdcfg), self.params,
                           adapter_cache=cache, **kw)
        return DecodeEngine(self.tm, self.scfg, self.tparams,
                            adapter_cache=cache, device="cpu", **kw)


@pytest.fixture(scope="module")
def model():
    return Model()


def _variant_kw(variant, pkg):
    if variant == "faulty":
        plan = (JPlan if pkg == "ref" else FaultPlan).parse("nan@3")
        return {"fault_plan": plan}, 3
    if variant == "spec":
        return {"speculative_k": 2}, None
    if variant == "paged":
        return {"paged": True}, None
    return {}, None


def drive(model, pkg, variant, trace):
    """The reference's ``_drive``: the four requests on adapter ``t0``
    through two slots, the last with the variant's deadline."""
    kw, deadline = _variant_kw(variant, pkg)
    eng = model.engine(pkg, model.cache(pkg), slots=2, max_len=ML,
                       trace=trace, **kw)
    for i, (p, (_, g)) in enumerate(zip(model.prompts, _REQS)):
        eng.submit(p, adapter="t0", max_new_tokens=g, key_id=i,
                   deadline_ticks=deadline if i == 3 else None)
    return eng.run(), eng


def streams(results):
    return {r.request_id: (r.tokens.tolist(), r.finish_reason)
            for r in results}


def events(rec) -> list:
    return [(e.name, e.tick, e.request_id, e.slot, e.data) for e in rec]


@pytest.mark.parametrize("variant", VARIANTS)
def test_event_stream_equals_reference(model, variant):
    ref_rec, port_rec = jobs.TraceRecorder(), tobs.TraceRecorder()
    ref_res, _ = drive(model, "ref", variant, ref_rec)
    port_res, _ = drive(model, "port", variant, port_rec)
    assert streams(port_res) == streams(ref_res)
    assert events(port_rec) == events(ref_rec)
    assert port_rec.emitted == ref_rec.emitted > 0
    names = Tally(e.name for e in port_rec)
    assert names["submitted"] == names["terminal"] == len(_REQS)
    if variant == "faulty":
        assert names["fault"] == 1 and names["quarantined"] >= 1
    if variant == "paged":
        assert names["chunk_prefill"] >= len(_REQS)


@pytest.mark.parametrize("variant", VARIANTS)
def test_tracing_changes_nothing(model, variant):
    off_res, off = drive(model, "port", variant, None)
    rec = tobs.TraceRecorder()
    on_res, on = drive(model, "port", variant, rec)
    assert streams(on_res) == streams(off_res)
    assert on.stats().as_dict() == off.stats().as_dict()
    assert on.device_steps() == off.device_steps()
    assert on.step_signatures() == off.step_signatures()
    assert len(rec) > 0 and rec.dropped == 0
    for e in rec:
        json.dumps(e.as_dict())        # raises on a tensor or numpy value
        assert e.name in tobs.EVENT_NAMES, e


def test_lifecycle_conservation_and_order(model):
    rec = tobs.TraceRecorder()
    results, _ = drive(model, "port", "clean", rec)
    assert rec.request_ids() == [0, 1, 2, 3]
    for rid in rec.request_ids():
        evs = rec.events(request_id=rid)
        names = [e.name for e in evs]
        assert names.count("submitted") == names.count("terminal") == 1
        assert names[0] == "submitted" and names[-1] == "terminal"
        assert evs[-1].data["reason"] in FINISH_REASONS
        assert [e.tick for e in evs] == sorted(e.tick for e in evs)
        assert names.count("first_token") == 1
        assert "token" not in names[:names.index("first_token")]
    for r in results:
        assert len(rec.events("first_token", r.request_id)) + len(
            rec.events("token", r.request_id)) == len(r.tokens)


def test_preemption_emits_preempt_resume_pair(model):
    out = {}
    for pkg, rec in (("ref", jobs.TraceRecorder()),
                     ("port", tobs.TraceRecorder())):
        eng = model.engine(pkg, model.cache(pkg), slots=1, max_len=ML,
                           trace=rec)
        eng.submit(model.prompts[0], adapter="t0", max_new_tokens=8)
        for _ in range(2):
            eng.step()
        eng.submit(model.prompts[1][:4], adapter="t0", max_new_tokens=2,
                   priority=5)
        results = {r.request_id: r for r in eng.run()}
        assert results[0].preempted == 1
        out[pkg] = events(rec)
    assert out["port"] == out["ref"]
    pre, res = rec.events("preempted", 0), rec.events("resumed", 0)
    assert len(pre) == len(res) == 1 and res[0].data["attempt"] == 1
    assert pre[0].tick <= res[0].tick
    assert len(rec.events("admitted", 0)) == 2
    assert len([e for e in rec.to_chrome_trace()["traceEvents"]
                if e["ph"] == "X" and e["name"] == "r0"]) == 2


def test_quarantine_and_chunk_events(model):
    rec = tobs.TraceRecorder()
    results, _ = drive(model, "port", "faulty", rec)
    poisoned = [r.request_id for r in results
                if r.finish_reason == "error_numeric"]
    assert poisoned and rec.events("fault")[0].data["kind"] == "nan"
    for rid in poisoned:
        (q,), (t,) = rec.events("quarantined", rid), rec.events("terminal",
                                                                  rid)
        assert t.data["reason"] == "error_numeric" and q.tick == t.tick
    rec = tobs.TraceRecorder()
    drive(model, "port", "paged", rec)
    for rid, (P, _) in enumerate(_REQS):
        chunks = rec.events("chunk_prefill", rid)
        assert sum(c.data["chunk_len"] for c in chunks) == P
        assert chunks[-1].data["final"] is True
        assert all(not c.data["final"] for c in chunks[:-1])


# ---------------------------------------------------------------------------
# The committed obs trace.
# ---------------------------------------------------------------------------

def _tick_pcts(xs) -> dict:
    """p50/p90/max with the obs layer's nearest-rank percentile (the
    committed model's definition)."""
    return {"p50": tobs.percentile(xs, 50), "p90": tobs.percentile(xs, 90),
            "max": float(max(xs)) if xs else 0.0}


def test_committed_obs_trace_gives_the_lifecycle_model(model):
    """``BENCH_serve.json``'s ``obs`` trace (12 requests, mean
    interarrival 0.5 ticks, 4 slots, max_len 18) through a traced
    single-tenant engine: the latencies derived from the trace are
    ``obs.lifecycle_model`` exactly, from 136 events, none dropped."""
    sec = json.loads((ROOT / "BENCH_serve.json").read_text())["obs"]
    tp, want = sec["trace"], sec["lifecycle_model"]
    rng = np.random.default_rng(tp["seed"])
    t, trace = 0.0, []
    for _ in range(tp["n_requests"]):
        t += rng.exponential(tp["mean_interarrival"])
        trace.append((int(t), tp["prompt_len"],
                      int(rng.choice(tp["gen_lens"]))))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, model.tm.vocab_size, r[1], dtype=np.int32)
               for r in trace]
    state = make_precompute_step(model.tm, model.scfg, fold_gsb=True)(
        model.tparams, tree_from_numpy(model.tenant))
    rec = tobs.TraceRecorder()
    eng = DecodeEngine(model.tm, model.scfg, model.tparams, adapters=state,
                       slots=tp["slots"], max_len=tp["max_len"], trace=rec,
                       device="cpu")
    i, step = 0, 0
    while i < len(trace) or eng.has_work():
        while i < len(trace) and trace[i][0] <= step:
            eng.submit(prompts[i], max_new_tokens=trace[i][2])
            i += 1
        eng.step()
        step += 1
    lat = tobs.lifecycle_latencies(rec)
    assert len(lat) == want["n_requests"] == 12
    per_tick = Tally(e.tick for e in rec if e.name == "token")
    occ = [per_tick[t] for t in sorted(per_tick)]
    got = {k: _tick_pcts([r[k] for r in lat.values()])
           for k in ("queue_wait_ticks", "ttft_ticks",
                     "admit_to_retire_ticks")}
    got["occupancy"] = {"p50": _tick_pcts(occ)["p50"],
                        "mean": sum(occ) / (len(occ) * tp["slots"])}
    for key in got:
        assert got[key] == want[key], key
    assert got["queue_wait_ticks"] == {"p50": 2.0, "p90": 5.0, "max": 7.0}
    assert got["admit_to_retire_ticks"] == {"p50": 6.0, "p90": 8.0,
                                            "max": 8.0}
    assert (rec.emitted, rec.dropped) == (sec["events"]["emitted"],
                                          sec["events"]["dropped"]) \
        == (136, 0)


# ---------------------------------------------------------------------------
# The cache's events and the metrics snapshot.
# ---------------------------------------------------------------------------

def test_traced_engine_claims_the_cache_hook(model):
    cache = model.cache("port")
    assert cache.on_event is None
    model.engine("port", cache, slots=2, max_len=ML,
                 trace=tobs.TraceRecorder())
    hook = cache.on_event
    assert hook is not None
    model.engine("port", cache, slots=2, max_len=ML)
    assert cache.on_event is hook, \
        "an untraced engine must not strip another engine's hook"


def test_spill_and_reload_events_land_on_the_engine_trace(model):
    """A tiered cache of one state's budget and two tenants: serving t0,
    t1, t0 spills t0, reloads it (spilling t1), and each tier move is an
    event on the traced engine's trace at its tick, in both packages."""
    out = {}
    for pkg, rec in (("ref", jobs.TraceRecorder()),
                     ("port", tobs.TraceRecorder())):
        cache = model.cache(pkg)
        params = model.params if pkg == "ref" else model.tparams
        cache.register("t1", model.tenant if pkg == "ref"
                       else tree_from_numpy(model.tenant))
        cache.get_state(params, cache.current_handle("t0"))
        cache.max_bytes = cache.stats().current_bytes
        cache.host_max_bytes = 10 * cache.max_bytes
        eng = model.engine(pkg, cache, slots=1, max_len=ML, trace=rec)
        for i, a in enumerate(("t1", "t0")):
            eng.submit(model.prompts[i], adapter=a, max_new_tokens=2)
            eng.run()
        out[pkg] = (events(rec), cache.stats().as_dict())
    assert out["port"] == out["ref"]
    assert [(e.name, e.data["adapter"]) for e in rec
            if e.name in ("spill", "reload")] == [
        ("spill", "t0"), ("reload", "t0"), ("spill", "t1")]
    st = out["port"][1]
    assert (st["spills"], st["reloads"]) == (2, 1)


def _names(parsed) -> set:
    return {k.split("{")[0] for k in parsed}


def test_engine_metrics_match_the_reference(model, tmp_path):
    """The snapshot of a traced paged engine: the reference's metric names
    (``device_steps_total`` in place of ``compiles_total``) and values,
    the stats counters, the pool gauges and the latency histograms."""
    regs = {}
    for pkg, mod in (("ref", jobs), ("port", tobs)):
        rec = mod.TraceRecorder()
        results, eng = drive(model, pkg, "paged", rec)
        regs[pkg] = (mod.engine_metrics(eng, rec), eng, results)
    port = tobs.parse_prometheus(regs["port"][0].to_prometheus())
    ref = jobs.parse_prometheus(regs["ref"][0].to_prometheus())
    assert _names(port) - {"repro_device_steps_total"} == \
        _names(ref) - {"repro_compiles_total"}
    same = {k: v for k, v in ref.items()
            if "compiles_total" not in k and "_seconds" not in k}
    assert {k: port[k] for k in same} == same
    _, eng, results = regs["port"]
    assert port["repro_engine_retired_total"] == eng.stats().retired
    assert port["repro_engine_slots"] == 2
    assert port["repro_adapter_cache_entries"] == 1
    assert port['repro_device_steps_total{fn="prefill_chunk",sig=""}'] == \
        eng.device_steps()["prefill_chunk"]
    assert port['repro_device_steps_total{fn="decode",sig="None"}'] == \
        eng.device_steps()["decode"]
    assert port["repro_pool_used_blocks"] == 0
    assert port['repro_pool_slot_blocks{slot="0"}'] == 0
    assert port["repro_ttft_ticks_count"] == len(results)
    snap = regs["port"][0].to_json(str(tmp_path / "m.json"))
    assert json.loads((tmp_path / "m.json").read_text()) == \
        json.loads(json.dumps(snap))
    assert snap["engine_retired_total"]["samples"][0]["value"] == 4
