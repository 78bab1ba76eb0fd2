"""The port's ``EngineServer`` and the serve CLI's engine paths against the
reference (``test_torch_fleet.py``'s model: qwen2-7b SMOKE in fp32, with
tenants whose B and m are perturbed by numpy, bridged into both packages'
caches).

  - the reference's ``TestEngineServer`` cases (``tests/test_engine.py``):
    mixed lengths and two adapters in one slot table, every request's
    tokens equal to the reference's ``EngineServer`` and to the port's
    ``generate`` alone; the engine persists across ``run`` calls and its
    counters accumulate; a bad request mid-batch queues nothing;
  - the reference's ``TestEngineServerPlumbing`` cases
    (``tests/test_faults.py``): scalar and per-request deadlines and
    priorities reach ``submit``, a wrong-length list raises with nothing
    queued, the fault plan passes through; a request whose adapter fails
    to resolve at admission ends ``"error"`` while the others are served;
  - the CLI on SMOKE in fp32: ``--continuous`` plain, ``--paged``,
    ``--speculative``, ``--inject`` with ``--deadline`` and ``--priority``,
    and ``--fleet``, each asserting its oracle; ``--trace-out`` as JSONL
    and as a Chrome trace and ``--metrics-out`` as Prometheus text, each
    parsed.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro.launch.faults import FaultPlan as JPlan
from repro.launch.serve import EngineServer as JServer
from repro.launch.serve import Request as JRequest
from repro_torch.bridge import tree_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch.engine import FINISH_REASONS
from repro_torch.launch.faults import FaultPlan
from repro_torch.obs import TraceRecorder, parse_prometheus

from test_torch_fleet import (ML, Fleet, _no_forced_tier,  # noqa: F401
                              _one_thread)


@pytest.fixture(scope="module")
def fleet():
    return Fleet()


def _requests(fleet, seed, spec):
    """(P, tenant) pairs → prompts drawn with numpy, as both packages'
    requests."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, fleet.tm.vocab_size, P, dtype=np.int32)
               for P, _ in spec]
    return ([tserve.Request(p, f"t{t}") for p, (_, t) in zip(prompts, spec)],
            [JRequest(p, f"t{t}") for p, (_, t) in zip(prompts, spec)])


def _port_server(fleet, cache, **kw):
    return tserve.EngineServer(fleet.tm, fleet.scfg, fleet.tparams,
                               cache=cache, device="cpu", **kw)


# ---------------------------------------------------------------------------
# The reference's TestEngineServer cases.
# ---------------------------------------------------------------------------

def test_mixed_lengths_and_adapters_match_reference_and_alone(fleet):
    """Mixed prompt lengths and two adapters in one slot table of 3: every
    request's tokens equal the reference server's and the request served
    alone; a second call on the same server serves the same requests
    again, and the engine's counters accumulate."""
    spec = [(5, 0), (7, 1), (4, 0), (6, 1)]
    reqs, jreqs = _requests(fleet, 9, spec)
    cache = fleet.port_cache(2)
    server = _port_server(fleet, cache, slots=3, max_len=ML)
    ref = JServer(fleet.jm, fleet.jscfg, fleet.params,
                  cache=fleet.ref_cache(2), slots=3, max_len=ML)
    got = server.run(reqs, gen_len=4)
    want = ref.run(jreqs, gen_len=4)
    assert [r.finish_reason for r in got] == ["length"] * 4
    for r, w, q in zip(got, want, reqs):
        assert r.tokens.tolist() == np.asarray(w.tokens).tolist()
        assert r.tokens.tolist() == fleet.alone(cache, q.prompt, 4,
                                                q.adapter)[0]
    st1 = server.engine.stats()
    assert st1.mean_occupancy > 0.5
    assert st1.as_dict() == ref.engine.stats().as_dict()
    again = server.run(reqs, gen_len=4)
    assert [r.tokens.tolist() for r in again] == \
        [r.tokens.tolist() for r in got]
    assert [r.request_id for r in again] == [4, 5, 6, 7]
    st2 = server.engine.stats()
    assert st2.admitted == 2 * st1.admitted == 8
    assert st2.generated_tokens == 2 * st1.generated_tokens == 32


def test_bad_request_mid_batch_queues_nothing(fleet):
    cache = fleet.port_cache(1)
    server = _port_server(fleet, cache, slots=2, max_len=10)
    (ok,), _ = _requests(fleet, 16, [(5, 0)])
    with pytest.raises(KeyError, match="not registered"):
        server.run([ok, tserve.Request(ok.prompt, "typo-id")], gen_len=2)
    with pytest.raises(ValueError, match="P \\+ 1 <= max_len"):
        server.run([ok, tserve.Request(np.zeros(10, np.int32), "t0")],
                   gen_len=2)
    assert not server.engine.has_work()
    seen = []
    results = server.run([ok], gen_len=2,
                         on_token=lambda rid, tok: seen.append(rid))
    assert len(results) == 1 and results[0].tokens.shape == (2,)
    assert set(seen) == {results[0].request_id}


def test_mesh_and_a_foreign_cache_are_refused(fleet):
    """Under a (one-rank) mesh the server's engine speculates as on no
    mesh: with k = 2 given at construction, and at run(speculative_k=2)
    on a server built plain, over two tenants, the results, the engine's
    stats and the cache's counts equal the no-mesh server's bit for bit.
    A cache keyed for no mesh is refused; an empty batch is; and a Mamba
    stack stays refused on a mesh (ROADMAP queue 1 item 6, second half,
    point 2)."""
    from repro_torch.configs import get_config
    from repro_torch.core.adapter_cache import AdapterStateCache
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import make_precompute_step

    cache = fleet.port_cache(1)
    one = make_debug_mesh(1, 1, device="cpu", backend="gloo")
    with pytest.raises(ValueError, match="keyed for sharding"):
        _port_server(fleet, cache, slots=2, max_len=8, mesh=one)
    reqs, _ = _requests(fleet, 16, [(5, 0), (4, 1), (6, 0)])
    runs = {}
    for m in (one, None):
        for when in ("built", "run"):
            if m is None:
                c = fleet.port_cache(2)
            else:
                c = AdapterStateCache.for_serving(fleet.tm, fleet.scfg,
                                                  mesh=m)
                for t in range(2):
                    c.register(f"t{t}", tree_from_numpy(fleet.tenants[t]))
            server = _port_server(fleet, c, slots=2, max_len=12, mesh=m,
                                  speculative_k=2 if when == "built" else 0)
            res = server.run(reqs, gen_len=3, speculative_k=(
                None if when == "built" else 2))
            assert server.engine.speculative_k == 2
            runs[when, m is None] = (
                [(r.tokens.tolist(), r.finish_reason) for r in res],
                server.engine.stats().as_dict(), c.stats().as_dict())
        assert runs["built", m is None][0] == runs["run", m is None][0]
    for when in ("built", "run"):
        assert runs[when, False] == runs[when, True]
        assert runs[when, False][1]["verify_steps"] > 0
    with pytest.raises(NotImplementedError, match="point 2"):
        make_precompute_step(get_config("falcon-mamba-7b", smoke=True),
                             fleet.scfg, one)
    with pytest.raises(ValueError, match="empty request batch"):
        _port_server(fleet, cache, slots=2, max_len=8).run([], gen_len=2)


# ---------------------------------------------------------------------------
# The reference's TestEngineServerPlumbing cases.
# ---------------------------------------------------------------------------

def test_per_request_deadlines_and_priorities(fleet):
    """Scalar and per-request deadlines and priorities reach submit, as in
    the reference; a wrong-length list fails before anything is queued."""
    reqs, jreqs = _requests(fleet, 15, [(5, 0), (6, 0)])
    server = _port_server(fleet, fleet.port_cache(1), slots=2, max_len=14)
    ref = JServer(fleet.jm, fleet.jscfg, fleet.params,
                  cache=fleet.ref_cache(1), slots=2, max_len=14)
    got = server.run(reqs, gen_len=8, deadline_ticks=2, priority=[0, 1])
    want = ref.run(jreqs, gen_len=8, deadline_ticks=2, priority=[0, 1])
    assert [r.finish_reason for r in got] == ["timeout"] * 2
    assert all(len(r.tokens) <= 3 for r in got)
    assert [r.tokens.tolist() for r in got] == \
        [np.asarray(w.tokens).tolist() for w in want]
    # per-request deadlines: only the first request expires
    got = server.run(reqs, gen_len=8, deadline_ticks=[2, None], priority=1)
    assert [r.finish_reason for r in got] == ["timeout", "length"]
    with pytest.raises(ValueError, match="deadline_ticks"):
        server.run(reqs, gen_len=2, deadline_ticks=[1, 2, 3])
    with pytest.raises(ValueError, match="priority"):
        server.run(reqs, gen_len=2, priority=[1])
    assert not server.engine.has_work()


def test_submit_receives_each_request_priority_and_deadline(fleet):
    server = _port_server(fleet, fleet.port_cache(1), slots=1, max_len=14)
    seen = []
    submit = server.engine.submit

    def spy(prompt, **kw):
        seen.append((kw["key_id"], kw["priority"], kw["deadline_ticks"]))
        return submit(prompt, **kw)
    server.engine.submit = spy
    reqs, _ = _requests(fleet, 17, [(4, 0), (5, 0), (3, 0)])
    server.run(reqs, gen_len=2, deadline_ticks=[None, 9, 7],
               priority=[0, 2, 1])
    assert seen == [(0, 0, None), (1, 2, 9), (2, 1, 7)]
    seen.clear()
    server.run(reqs[:2], gen_len=2, deadline_ticks=5, priority=3)
    assert seen == [(0, 3, 5), (1, 3, 5)]


def test_server_fault_plan_pass_through(fleet):
    reqs, jreqs = _requests(fleet, 16, [(5, 0), (5, 0)])
    server = _port_server(fleet, fleet.port_cache(1), slots=2, max_len=12,
                          fault_plan=FaultPlan.parse("nan@1:1"))
    ref = JServer(fleet.jm, fleet.jscfg, fleet.params,
                  cache=fleet.ref_cache(1), slots=2, max_len=12,
                  fault_plan=JPlan.parse("nan@1:1"))
    got = server.run(reqs, gen_len=5)
    want = ref.run(jreqs, gen_len=5)
    assert sorted(r.finish_reason for r in got) == ["error_numeric",
                                                    "length"]
    assert [r.finish_reason for r in got] == [w.finish_reason for w in want]
    assert server.engine.stats().quarantined == 1


def test_an_adapter_that_fails_at_admission_ends_error_alone(fleet):
    """A ``stale`` fault hands the first admission a handle one version
    ahead: its adapter fails to resolve, it ends "error" with the cache's
    stale error, and the other requests are served as they would be
    without it."""
    spec = [(5, 0), (6, 1), (4, 0)]
    reqs, _ = _requests(fleet, 18, spec)
    cache = fleet.port_cache(2)
    server = _port_server(fleet, cache, slots=2, max_len=ML,
                          fault_plan=FaultPlan.parse("stale@0"))
    got = server.run(reqs, gen_len=3)
    assert [r.finish_reason for r in got] == ["error", "length", "length"]
    assert got[0].error_type == "AdapterCacheMiss"
    assert "stale" in got[0].error_message
    for r, q in zip(got[1:], reqs[1:]):
        assert r.tokens.tolist() == fleet.alone(cache, q.prompt, 3,
                                                q.adapter)[0]
    assert server.engine.stats().stale_injected == 1
    assert not server.engine.has_work()


# ---------------------------------------------------------------------------
# The serve CLI's engine paths on SMOKE (fp32: every oracle asserted).
# ---------------------------------------------------------------------------

CLI = ["--arch", "qwen2-7b", "--smoke", "--device", "cpu", "--batch", "3",
       "--prompt-len", "12", "--gen-len", "4"]


def _cli(capsys, *flags) -> str:
    tserve.main([*CLI, *flags])
    return capsys.readouterr().out


@pytest.mark.parametrize("flags,oracle", [
    ((), None),
    (("--paged", "--block-size", "4"), "paged vs plain rectangular"),
    (("--speculative", "2"), "speculative vs plain rectangular"),
    (("--paged", "--speculative", "3"),
     "paged speculative vs plain rectangular"),
])
def test_cli_continuous_modes_assert_their_oracles(capsys, flags, oracle):
    out = _cli(capsys, "--continuous", *flags)
    assert "continuous: 6 mixed-length requests through 3 slots on cpu" \
        in out
    if oracle is None:
        assert "oracle" not in out
    else:
        assert f"{oracle}: greedy streams equal (oracle OK, fp32)" in out
    if "--paged" in flags:
        assert "(pool drained)" in out and "'prefill_into_slot': 0" in out
    if "--speculative" in flags:
        assert "drafts accepted" in out


def test_cli_faults_deadline_and_priority_finish_every_request(capsys):
    out = _cli(capsys, "--continuous", "--paged", "--inject",
               "nan@3:1,slow@4", "--deadline", "8", "--priority", "1",
               "--block-size", "4")
    line = next(ln for ln in out.splitlines() if "finish reasons" in ln)
    reasons = dict(eval(line.split("finish reasons ")[1]))
    assert sum(reasons.values()) == 6
    assert set(reasons) <= set(FINISH_REASONS)
    assert reasons.get("error_numeric") == 1 and reasons.get("timeout")
    assert "slow_ticks=1" in out and "(pool drained)" in out
    assert "oracle" not in out      # a faulty run is not compared


def test_cli_fleet_asserts_one_signature_and_the_static_oracle(capsys):
    out = _cli(capsys, "--fleet", "4")
    assert "fleet: 6 requests x 4 tenants through 3 slots on cpu" in out
    assert "one dynamic decode signature" in out
    assert "fleet dynamic vs static: greedy streams equal (oracle OK, " \
           "fp32)" in out


@pytest.mark.parametrize("mode", [("--continuous", "--speculative", "2"),
                                  ("--fleet", "3")])
def test_cli_trace_and_metrics_files_parse(capsys, tmp_path, mode):
    jsonl, chrome, prom = (tmp_path / "t.jsonl", tmp_path / "t.json",
                           tmp_path / "m.prom")
    out = _cli(capsys, *mode, "--trace-out", str(jsonl), "--metrics-out",
               str(prom))
    events = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    assert events and f"{len(events)} events (0 dropped)" in out
    names = {e["name"] for e in events}
    assert {"submitted", "admitted", "first_token", "terminal"} <= names
    assert sum(e["name"] == "submitted" for e in events) == 6
    metrics = parse_prometheus(prom.read_text())
    assert metrics["repro_engine_generated_tokens_total"] == 24
    _cli(capsys, *mode, "--trace-out", str(chrome))
    trace = json.loads(chrome.read_text())
    assert trace["traceEvents"] and all(
        {"ph", "ts", "pid", "tid"} <= set(e) for e in trace["traceEvents"]
        if e["ph"] != "M")


def test_trace_recorder_is_what_the_cli_writes(fleet, tmp_path):
    """``_dump_obs`` writes the recorder's own exports."""
    trace = TraceRecorder()
    server = _port_server(fleet, fleet.port_cache(1), slots=2, max_len=10,
                          trace=trace)
    reqs, _ = _requests(fleet, 19, [(4, 0), (5, 0)])
    server.run(reqs, gen_len=2)

    class Args:
        trace_out = str(tmp_path / "t.jsonl")
        metrics_out = str(tmp_path / "m.prom")
    tserve._dump_obs(trace, server.engine, Args)
    assert (tmp_path / "t.jsonl").read_text() == trace.to_jsonl()
    assert parse_prometheus((tmp_path / "m.prom").read_text())[
        "repro_engine_admitted_total"] == 2
    assert torch.get_num_threads() == 1      # the fleet file's fixture
