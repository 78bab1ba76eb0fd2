"""The port's fault plan against the reference.

``repro_torch.launch.faults`` is the port's own copy of the reference's
numpy-only module: the same specs and seeds give the same events, and the
same bad specs are refused. The engines run the model of
``test_torch_speculative.py`` (2 layers in fp32, adapters perturbed so that
about a third of the drafts are accepted) over the reference property
suite's fault trace (4 requests, 2 slots, max_len 12), under the same
plans, among them ``FaultPlan.random`` at seeds 94 and 142, the examples
that ROADMAP queue 3 pins. Held: equal streams, finish reasons and
``stats()``, the containment of the reference's property test (every
request finishes once, no slot or block leaks, unaffected streams equal
the clean run's and affected ones are a prefix of it), and, inside a
speculative verify, a poisoned row quarantined alone.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.launch import faults as jfaults
from repro_torch.launch import faults as tfaults
from repro_torch.launch.engine import FINISH_REASONS
from test_torch_engine import _no_forced_tier
from test_torch_speculative import V, _engines, _one_thread, _port, drafty

__all__ = ["_no_forced_tier", "_one_thread", "drafty"]   # fixtures
FAULT_ML = 12
FAULT_REQS = [(5, 4), (6, 5), (4, 3), (5, 4)]   # (prompt_len, budget)


def _events(plan):
    return [(e.kind, e.step, e.slot, e.duration_s) for e in plan.events]


# ---------------------------------------------------------------------------
# The plan.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    " nan@3:1, evict@5, stale@2 ,slow@4 ", "nan@7", "", None,
    "slow@1,slow@1,nan@0:0,nan@0", "evict@0,stale@9,nan@2:1"])
def test_parse_gives_the_reference_events(spec):
    got, want = tfaults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    assert _events(got) == _events(want)
    for step in range(10):
        assert got.nan_slots(step) == want.nan_slots(step)
        assert got.evict_at(step) == want.evict_at(step)
        assert got.stale_at(step) == want.stale_at(step)
        assert got.slow_at(step) == want.slow_at(step)
    assert got.last_step == want.last_step and len(got) == len(want)


@pytest.mark.parametrize("seed,kw", [
    (94, {}), (142, {}), (7, dict(n_nan=2, n_evict=1, n_stale=1, n_slow=1)),
    (94, dict(n_nan=2, n_evict=1, n_stale=1, n_slow=1)),
    (3, dict(n_nan=0, n_slow=2))])
def test_random_gives_the_reference_events(seed, kw):
    got = tfaults.FaultPlan.random(seed, steps=12, slots=2, **kw)
    want = jfaults.FaultPlan.random(seed, steps=12, slots=2, **kw)
    assert _events(got) == _events(want)
    assert got == tfaults.FaultPlan.random(seed, steps=12, slots=2, **kw)


@pytest.mark.parametrize("spec", ["explode@3", "nan@notanumber", "nan",
                                  "nan@-1", "slow@2:x"])
def test_bad_specs_are_refused_like_the_reference(spec):
    with pytest.raises(ValueError) as want:
        jfaults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as got:
        tfaults.FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


def test_event_validation_and_slow_cap():
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS
    assert tfaults.MAX_SLOW_S == jfaults.MAX_SLOW_S
    with pytest.raises(ValueError, match="kind"):
        tfaults.FaultEvent(kind="explode", step=1)
    with pytest.raises(ValueError, match="step"):
        tfaults.FaultEvent(kind="nan", step=-1)
    plan = tfaults.FaultPlan(events=(
        tfaults.FaultEvent("slow", 2, duration_s=10.0),
        tfaults.FaultEvent("slow", 2, duration_s=10.0)))
    assert plan.slow_at(2) == tfaults.MAX_SLOW_S
    assert plan != tfaults.FaultPlan() and tfaults.FaultPlan.parse("") == \
        tfaults.FaultPlan()


# ---------------------------------------------------------------------------
# The engine under a plan.
# ---------------------------------------------------------------------------

def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, V, P, dtype=np.int32) for P, _ in FAULT_REQS]


def _run(engine, deadline=None):
    """The property suite's fault trace, all submitted at once; request 3
    carries the deadline. Returns {id: (tokens, reason)} and the
    stats."""
    for i, (p, (_, g)) in enumerate(zip(_prompts(), FAULT_REQS)):
        engine.submit(p, max_new_tokens=g, key_id=i,
                      deadline_ticks=deadline if i == 3 else None)
    results = engine.run()
    return ({r.request_id: (r.tokens.tolist(), r.finish_reason)
             for r in results}, engine.stats().as_dict())


def _plans():
    rand = tfaults.FaultPlan.random
    jrand = jfaults.FaultPlan.random
    every = dict(n_nan=2, n_evict=1, n_stale=1, n_slow=1)
    return {
        "seed142": (rand(142, steps=12, slots=2, n_nan=1),
                    jrand(142, steps=12, slots=2, n_nan=1)),
        "seed94": (rand(94, steps=12, slots=2, **every),
                   jrand(94, steps=12, slots=2, **every)),
        "seed5": (rand(5, steps=12, slots=2, **every),
                  jrand(5, steps=12, slots=2, **every)),
        "spec": (tfaults.FaultPlan.parse("nan@2:1,slow@1,stale@0,evict@3"),
                 jfaults.FaultPlan.parse("nan@2:1,slow@1,stale@0,evict@3")),
        "all-rows": (tfaults.FaultPlan.parse("nan@3"),
                     jfaults.FaultPlan.parse("nan@3"))}


@pytest.mark.parametrize("name,speculative_k,deadline,paged", [
    ("seed142", 0, None, False), ("seed94", 0, None, False),
    ("seed94", 0, 3, False), ("seed5", 0, None, False),
    ("spec", 0, None, False), ("all-rows", 0, None, False),
    ("spec", 2, None, False), ("seed94", 2, 3, False),
    ("seed94", 0, 3, True), ("spec", 2, None, True)])
def test_engine_under_a_plan_matches_reference(drafty, name, speculative_k,
                                               deadline, paged):
    """The same streams, finish reasons and ``stats()`` as the reference
    under the same plan (paged: blocks of 4, chunks of 3, and the same
    pool accounting), and the reference property suite's containment
    against the port's own clean run."""
    t_plan, j_plan = _plans()[name]
    kw = dict(slots=2, max_len=FAULT_ML, speculative_k=speculative_k)
    if paged:
        kw.update(paged=True, block_size=4, prefill_chunk=3)
    ref, _ = _engines(drafty, fault_plan=j_plan, **kw)
    port = _port(drafty, fault_plan=t_plan, **kw)
    res, st = _run(port, deadline)
    assert (res, st) == _run(ref, deadline)
    clean, _ = _run(_port(drafty, **kw))
    assert sorted(res) == [0, 1, 2, 3]
    assert not port.has_work()
    if paged:
        assert port.pool_stats() == ref.pool_stats()
        assert port.pool_stats()["used_blocks"] == 0
    for rid, (toks, reason) in res.items():
        assert reason in FINISH_REASONS
        if reason in ("error_numeric", "timeout"):
            assert toks == clean[rid][0][:len(toks)], rid
        else:
            assert (toks, reason) == clean[rid], rid
    assert st["forced_evictions"] == st["stale_injected"] == 0
    assert st["slow_ticks"] == sum(
        1 for s in range(st["steps"]) if t_plan.slow_at(s) > 0)
    steps = port.device_steps()
    assert set(steps) == {"prefill_into_slot", "prefill_chunk", "decode",
                          "draft", "verify"}
    if name == "seed142":
        # The reference's rule for a slot refilled in the tick that
        # poisons it: every admission into slot 0 during tick 0 is
        # poisoned, so all four requests end error_numeric there and no
        # decode step runs (ROADMAP queue 3).
        assert [e for e in t_plan.events] == [
            tfaults.FaultEvent("nan", step=0, slot=0)]
        assert {r for _, r in res.values()} == {"error_numeric"}
        assert st["injected_nans"] == st["quarantined"] == 4
        assert st["steps"] == 1 and steps["decode"] == 0


def test_one_row_nan_leaves_its_neighbour_untouched(drafty):
    """A NaN on slot 1 at tick 2 retires that row ``error_numeric`` with
    its tokens so far; the other rows' streams equal the clean run's."""
    kw = dict(slots=2, max_len=FAULT_ML)
    clean, _ = _run(_port(drafty, **kw))
    plan = tfaults.FaultPlan.parse("nan@2:1")
    got, st = _run(_port(drafty, fault_plan=plan, **kw))
    hit = [rid for rid, (_, r) in got.items() if r == "error_numeric"]
    assert len(hit) == 1 and st["injected_nans"] == st["quarantined"] == 1
    for rid, (toks, reason) in got.items():
        if rid in hit:
            assert 0 < len(toks) < len(clean[rid][0])
            assert toks == clean[rid][0][:len(toks)]
        else:
            assert (toks, reason) == clean[rid]


def test_a_fault_inside_a_verify_quarantines_only_its_row(drafty):
    """Speculative engine: a NaN on slot 0 at tick 1, a verify tick, is
    caught before acceptance. That row emits nothing more and its rewind
    target is 0; the other row's stream equals the clean speculative run's
    and the reference's."""
    kw = dict(slots=2, max_len=FAULT_ML, speculative_k=2)
    clean, clean_st = _run(_port(drafty, **kw))
    plans = (tfaults.FaultPlan.parse("nan@1:0"),
             jfaults.FaultPlan.parse("nan@1:0"))
    port = _port(drafty, fault_plan=plans[0], **kw)
    ref, _ = _engines(drafty, fault_plan=plans[1], **kw)
    got, st = _run(port)
    assert (got, st) == _run(ref)
    assert st["verify_steps"] > 0 and clean_st["verify_steps"] > 0
    hit = [rid for rid, (_, r) in got.items() if r == "error_numeric"]
    assert hit == [0] and st["injected_nans"] == 1
    # Request 0 took one token at admission (tick 0) and its tick-0 verify
    # window; the poisoned verify at tick 1 added none.
    assert got[0][0] == clean[0][0][:len(got[0][0])]
    for rid in (1, 2, 3):
        assert got[rid] == clean[rid]
