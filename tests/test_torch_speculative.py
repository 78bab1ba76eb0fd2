"""The port's speculative decoding against the reference.

The model is ``test_torch_engine.py``'s: 2 layers in fp32, d_model 256,
one KV head of 128, r = 16, its adapters perturbed with numpy and the
same weights bridged into the port. Held here:

  - the draft and verify steps against the reference's on per-row
    frontiers, rectangular and paged (logits within 1e-5 of max |logit|,
    as the engine's other steps: the two frameworks' fp32 sums part by
    0.9e-6 to 1.8e-6 of it here; equal lengths), and a draft that calls
    no ``dora_linear``;
  - the engines on the committed ``speculative`` trace of
    ``BENCH_serve.json``: with identity adapters (B = 0; the port's m is
    the norm its precompute computes, so g == 1 exactly; the reference's
    tree has g = 1 written in) the counters equal the committed
    ``speculative_model`` and the reference's, and
    speculative streams equal plain ones; with perturbed adapters the
    streams and ``stats()`` equal the reference's, the ladder too;
  - the fallbacks (temperature > 0, the max_len cap), paged speculative
    streams equal rectangular ones, the rewind invariants of the
    reference's property suite and block conservation with
    ``speculative_k=2``, over numpy seeds.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import DoRAConfig as JConfig
from repro.launch import steps as jsteps
from repro.launch.engine import DecodeEngine as JEngine
from repro.launch.train import build_state
from repro.models import init_cache as j_init_cache
from repro.models.config import ModelConfig as JModel
from repro_torch.bridge import flatten_paths, tree_from_numpy
from repro_torch.core.adapter import compute_weight_norm
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig
from test_torch_engine import (ALPHA, RANK, ROOT, WIDTHS, _TRACE,
                               _arrival_trace, _close, _drive, _jstep,
                               _no_forced_tier, _port_engine, _prompts,
                               _tstep, gather_calls, state)

__all__ = ["_no_forced_tier", "gather_calls", "state"]   # fixtures
V = WIDTHS["vocab_size"]
K = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's many small ops: under a test
    run of several workers, each worker's default pool of one thread a
    core oversubscribes the machine and every small op waits on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec_trace():
    """(trace, slots, max_len, k, committed speculative_model) of
    ``BENCH_serve.json``'s ``speculative`` section."""
    sec = json.loads((ROOT / "BENCH_serve.json").read_text())["speculative"]
    tp = sec["trace"]
    trace = _arrival_trace(n_requests=tp["n_requests"],
                           mean_interarrival=tp["mean_interarrival"],
                           prompt_len=tp["prompt_len"],
                           gen_lens=tuple(tp["gen_lens"]), seed=tp["seed"])
    return trace, tp["slots"], tp["max_len"], tp["k"], \
        sec["speculative_model"]


def _serving(*, identity: bool):
    """(jm, reference params, reference serving tree, tm, port params,
    port serving tree) from the reference's ``build_state`` (B = 0).

    ``identity``: the port's m is set to the norm that its own precompute
    computes, so its g is exactly 1 and gsB == 0 (asserted): the adapted
    path is bitwise the base path and every draft is accepted. The
    reference's serving tree gets g = 1 and gsB = 0 written in: XLA
    compiles a standalone norm and the precompute's apart, and their bits
    can differ by an ulp, so m = norm alone does not give it g == 1. Else
    B = 0.01 x N(0, 1) and m = ||W||·(1 + 0.01·noise): about a third of
    the drafts are accepted on the committed trace."""
    jm = JModel(**WIDTHS, dtype=jnp.float32)
    jcfg = JConfig(rank=RANK, alpha=ALPHA, mode="eager")
    params, adapters, _ = build_state(jm, jcfg, 0)
    params = jax.tree_util.tree_map(np.array, params)
    adapters = jax.tree_util.tree_map(np.array, adapters)
    rng = np.random.default_rng(0)
    for name, leaf in flatten_paths(adapters).items():
        if not identity and name.endswith("/B"):
            leaf[...] = 0.01 * rng.standard_normal(leaf.shape)
        elif not identity and name.endswith("/m"):
            leaf *= 1 + 0.01 * rng.standard_normal(leaf.shape).astype(
                np.float32)
    j_state = jax.jit(jsteps.make_precompute_step(
        jm, jsteps.StepConfig(dora=jcfg), fold_gsb=True))(params, adapters)
    if identity:
        j_state = jax.tree_util.tree_map(np.array, j_state)
        for name, leaf in flatten_paths(j_state).items():
            if name.endswith("/g"):
                leaf[...] = 1.0
            elif name.endswith("/gsB"):
                leaf[...] = 0.0

    tm = ModelConfig(**WIDTHS, dtype=torch.float32)
    t_params = tree_from_numpy(params)
    t_adapters = tree_from_numpy(adapters)
    tfp, tfa = flatten_paths(t_params), flatten_paths(t_adapters)
    for name, m in tfa.items():
        if identity and name.endswith("/m"):
            pre = name[:-2]
            for i in range(m.shape[0]):
                m[i] = compute_weight_norm(tfp[pre][i], tfa[pre + "/A"][i],
                                           tfa[pre + "/B"][i], _tstep().dora)
    t_state = tsteps.make_precompute_step(tm, _tstep(), fold_gsb=True)(
        t_params, t_adapters)
    if identity:
        for name, leaf in flatten_paths(t_state).items():
            if name.endswith("/g"):
                assert bool((leaf == 1.0).all()), name
            elif name.endswith("/gsB"):
                assert not leaf.any(), name
    return jm, params, j_state, tm, t_params, t_state


@pytest.fixture(scope="module")
def identity():
    return _serving(identity=True)


@pytest.fixture(scope="module")
def drafty():
    return _serving(identity=False)


# ---------------------------------------------------------------------------
# The steps.
# ---------------------------------------------------------------------------

def _caches(jm, tm, *, paged: bool, slots: int, max_len: int):
    """Both packages' row-length caches, paged with an out-of-order block
    table when asked (blocks of 4, 12 of them)."""
    kw = dict(block_size=4, n_blocks=12) if paged else {}
    j_cache = j_init_cache(jm, slots, max_len, row_lens=True, **kw)
    t_cache = tlm.init_cache(tm, slots, max_len, row_lens=True, **kw)
    if paged:
        pages = np.full((slots, max_len // 4), -1, np.int32)
        pages[0, :4] = [9, 2, 7, 0]
        pages[1, :4] = [11, 4, 5, 3]
        pages[2, :3] = [1, 10, 6]
        j_cache["pages"] = jnp.asarray(pages)
        t_cache["pages"] = torch.as_tensor(pages)
    return j_cache, t_cache


@pytest.mark.parametrize("paged", [False, True], ids=["rect", "paged"])
def test_draft_and_verify_steps_match_reference(state, paged, gather_calls):
    """Three rows at the frontiers 9, 4 and 6 (prefilled by one batched
    decode-shaped forward of each package's own base model, then rewound
    per row): k = 3 drafts, a rewind, then the k + 1 verify through the
    folded serving tree. Logits within 1e-5 of max |logit|, equal lengths;
    on the paged cache every step gathers through the K8 wrapper twice a
    layer."""
    jm, j_serving, j_params, tm, t_params, t_serving = state
    slots, max_len = 3, 16
    j_cache, t_cache = _caches(jm, tm, paged=paged, slots=slots,
                               max_len=max_len)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, V, (slots, 9)).astype(np.int32)
    j_fill = jax.jit(jsteps.make_verify_step(jm, _jstep(), batch=slots,
                                             window=9))
    t_fill = tsteps.make_verify_step(tm, _tstep(), batch=slots, window=9)
    _, j_cache = j_fill(j_params, j_serving, j_cache,
                        {"tokens": jnp.asarray(toks)})
    _, t_cache = t_fill(t_params, t_serving, t_cache,
                        {"tokens": torch.as_tensor(toks).long()})
    lens = np.array([9, 4, 6], np.int32)
    j_cache = dict(j_cache, len=jnp.asarray(lens))
    t_cache["len"] = torch.tensor(lens)
    j_draft = jax.jit(jsteps.make_draft_step(jm, _jstep(), batch=slots))
    t_draft = tsteps.make_draft_step(tm, _tstep(), batch=slots)
    cur = rng.integers(0, V, (slots, 1)).astype(np.int32)
    window = [cur]
    gather_calls[0] = 0
    for _ in range(K):
        j_lg, j_cache = j_draft(j_params, j_cache,
                                {"tokens": jnp.asarray(cur)})
        t_lg, t_cache = t_draft(t_params, t_cache,
                                {"tokens": torch.as_tensor(cur).long()})
        _close(t_lg, j_lg)
        cur = np.argmax(np.asarray(j_lg), -1)[:, None].astype(np.int32)
        window.append(cur)
    np.testing.assert_array_equal(t_cache["len"].numpy(),
                                  np.asarray(j_cache["len"]))
    assert t_cache["len"].tolist() == (lens + K).tolist()
    j_cache = dict(j_cache, len=jnp.asarray(lens))
    t_cache["len"] = torch.tensor(lens)
    win = np.concatenate(window, axis=1)
    j_ver = jax.jit(jsteps.make_verify_step(jm, _jstep(), batch=slots,
                                            window=K + 1))
    t_ver = tsteps.make_verify_step(tm, _tstep(), batch=slots, window=K + 1)
    j_lg, j_cache = j_ver(j_params, j_serving, j_cache,
                          {"tokens": jnp.asarray(win)})
    t_lg, t_cache = t_ver(t_params, t_serving, t_cache,
                          {"tokens": torch.as_tensor(win).long()})
    assert tuple(t_lg.shape) == (slots, K + 1, V)
    _close(t_lg, j_lg)
    np.testing.assert_array_equal(t_cache["len"].numpy(),
                                  np.asarray(j_cache["len"]))
    assert t_cache["len"].tolist() == (lens + K + 1).tolist()
    assert gather_calls[0] == (2 * WIDTHS["num_layers"] * (K + 1)) * paged


def test_draft_runs_no_adapted_linear(state, monkeypatch):
    """The draft takes ``maybe_dora``'s base matmul for every projection:
    no ``dora_linear`` call; the verify makes one per adapted module."""
    _, _, _, tm, t_params, t_serving = state
    calls = [0]
    real = tlayers.dora_linear

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)
    monkeypatch.setattr(tlayers, "dora_linear", counted)
    cache = tlm.init_cache(tm, 2, 8, row_lens=True)
    tok = torch.zeros((2, 1), dtype=torch.long)
    tsteps.make_draft_step(tm, _tstep(), batch=2)(t_params, cache,
                                                  {"tokens": tok})
    assert calls[0] == 0
    tsteps.make_verify_step(tm, _tstep(), batch=2, window=2)(
        t_params, t_serving, cache, {"tokens": tok.expand(2, 2)})
    assert calls[0] == 7 * WIDTHS["num_layers"]


def test_step_contracts(state):
    _, _, _, tm, t_params, t_serving = state
    cache = tlm.init_cache(tm, 2, 8, row_lens=True)
    with pytest.raises(ValueError, match="draft built for tokens"):
        tsteps.make_draft_step(tm, _tstep(), batch=2)(
            t_params, cache, {"tokens": torch.zeros((2, 2), dtype=torch.long)})
    with pytest.raises(ValueError, match="verify built for tokens"):
        tsteps.make_verify_step(tm, _tstep(), batch=2, window=3)(
            t_params, t_serving, cache,
            {"tokens": torch.zeros((2, 2), dtype=torch.long)})
    with pytest.raises(ValueError, match="adapter_idx"):
        tsteps.make_verify_step(tm, _tstep(), batch=2, window=3,
                                tenant_groups=((0, 2),), dynamic_groups=True)
    with pytest.raises(ValueError, match="speculative_k"):
        _port_engine(state, slots=2, max_len=16, speculative_k=-1)
    for flag, value in (("--speculative", "2"), ("--inject", "nan@3"),
                        ("--deadline", "4")):
        with pytest.raises(NotImplementedError, match="item 4.5"):
            tserve.main(["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
                         flag, value])
    for floor in (-0.1, 1.5):
        with pytest.raises(ValueError, match="spec_accept_floor"):
            _port_engine(state, slots=2, max_len=16, speculative_k=2,
                         spec_accept_floor=floor)


# ---------------------------------------------------------------------------
# The engines on the committed speculative trace.
# ---------------------------------------------------------------------------

def _stats(engine) -> dict:
    return engine.stats().as_dict()


def _port(serving, **kw):
    """The port's engine on one ``_serving`` tree."""
    _, _, _, tm, t_params, t_state = serving
    return DecodeEngine(tm, _tstep(), t_params, adapters=t_state,
                        device="cpu", **kw)


def _engines(serving, **kw):
    """The reference's and the port's engine on one ``_serving`` tree."""
    jm, j_params, j_state = serving[:3]
    return (JEngine(jm, _jstep(), j_params, adapters=j_state, **kw),
            _port(serving, **kw))


def test_identity_adapters_reach_the_committed_model(identity):
    """Identity adapters: the port's seven counters equal the committed
    ``speculative_model`` (45 drafts, 15 verifies, 63 accepted), all of
    ``stats()`` equals the reference's, and the speculative streams equal
    the reference's and the port's plain ones."""
    trace, slots, max_len, k, model = _spec_trace()
    prompts = _prompts(trace)
    kw = dict(slots=slots, max_len=max_len)
    ref, port = _engines(identity, speculative_k=k, **kw)
    want = _drive(ref, trace, prompts)
    got = _drive(port, trace, prompts)
    plain = _port(identity, **kw)
    assert got == want == _drive(plain, trace, prompts)
    st = _stats(port)
    assert st == _stats(ref)
    assert {f: st[f] for f in model} == model
    assert port.device_steps()["draft"] == model["draft_steps"] == 45
    assert port.device_steps()["verify"] == model["verify_steps"] == 15
    assert port.device_steps()["decode"] == model["decode_steps"]


@pytest.mark.parametrize("ladder", [False, True], ids=["spec", "ladder"])
def test_perturbed_adapters_match_reference(drafty, ladder):
    """Perturbed adapters: some drafts diverge from the adapted path, and
    the streams, finish reasons and ``stats()`` equal the reference's.
    With the ladder (floor 0.99, window 2, re-enable 2) both disable and
    re-enable speculation the same number of times."""
    trace, slots, max_len, k, _ = _spec_trace()
    prompts = _prompts(trace)
    kw = dict(slots=slots, max_len=max_len, speculative_k=k)
    if ladder:
        kw.update(spec_accept_floor=0.99, spec_window=2,
                  spec_reenable_after=2)
    ref, port = _engines(drafty, **kw)
    out = {}
    for name, engine in (("ref", ref), ("port", port)):
        streams = _drive(engine, trace, prompts)
        res = [(r.request_id, r.finish_reason, r.admitted_step,
                r.finished_step) for r in engine.pop_results()]
        out[name] = (streams, res, _stats(engine))
    assert out["port"] == out["ref"]
    st = out["port"][2]
    assert 0 < st["accepted_drafts"] < k * st["verify_steps"]
    if ladder:
        assert st["spec_disables"] >= 1 and st["spec_reenables"] >= 1
    else:
        assert st["spec_disables"] == st["spec_reenables"] == 0
    plain = _port(drafty, slots=slots, max_len=max_len)
    assert out["port"][0] == _drive(plain, trace, prompts)


def test_fallbacks_decode_plainly(drafty):
    """At temperature > 0 no tick drafts; a row whose k + 1 window would
    pass ``max_len`` makes its ticks plain decodes. The streams equal the
    plain engine's either way."""
    trace = [(0, 8, 6), (0, 6, 9), (1, 5, 4)]
    prompts = _prompts(trace, seed=6)
    runs = {}
    for temp in (0.0, 0.9):
        for spec in (0, K):
            engine = _port(drafty, slots=2, max_len=16,
                           temperature=temp, seed=2, speculative_k=spec)
            runs[temp, spec] = (_drive(engine, trace, prompts), engine)
    for temp in (0.0, 0.9):
        assert runs[temp, K][0] == runs[temp, 0][0]
    hot = runs[0.9, K][1]
    assert hot.device_steps()["draft"] == hot.stats().verify_steps == 0
    greedy = runs[0.0, K][1]
    st = greedy.stats()
    assert st.verify_steps > 0 and st.draft_steps == K * st.verify_steps
    # request 1 (P 6, budget 9) reaches max_len 16: its last tokens cannot
    # hold a 4-token window, so those ticks decode plainly.
    assert st.decode_steps > 0
    assert greedy.device_steps()["decode"] == st.decode_steps


@pytest.mark.parametrize("paged_kw", [
    {"block_size": 6},                          # chunk 6 < P = 8
    {"block_size": 6, "prefill_chunk": 9},      # one chunk per prompt
    {"block_size": 6, "n_blocks": 8},           # deferral + reclaim
], ids=["chunked", "one-chunk", "small-pool"])
def test_paged_speculative_streams_equal_rectangular(drafty, paged_kw):
    prompts = _prompts(_TRACE, seed=0)
    rect = _port(drafty, slots=4, max_len=18, speculative_k=2)
    paged = _port(drafty, slots=4, max_len=18, paged=True,
                  speculative_k=2, **paged_kw)
    want = _drive(rect, _TRACE, prompts)
    got = _drive(paged, _TRACE, prompts)
    assert got == want
    ps = paged.pool_stats()
    assert ps["used_blocks"] == 0 and ps["per_slot_blocks"] == [0] * 4
    assert paged.stats().verify_steps > 0
    assert paged.stats().accepted_drafts > 0


# ---------------------------------------------------------------------------
# The rewind invariants (the reference's property suite, as numpy seeds).
# ---------------------------------------------------------------------------

_REWIND_ML, _REWIND_SEED_LEN = 12, 7


def _base_step(state):
    """A forward of the port's base model (no adapters) over a cache."""
    _, _, _, tm, t_params, _ = state

    def step(cache, toks):
        with torch.no_grad():
            return tlm.forward(tm, t_params, {}, _tstep().dora,
                               tokens=torch.as_tensor(toks).long(),
                               cache=cache, training=False)
    return tm, step


def _rewind_start(state, seed):
    """Two rows written with 7 tokens, then truncated to frontiers (l0,
    l1): positions past them hold dead K/V, as a rewound draft leaves
    them."""
    tm, step = _base_step(state)
    rng = np.random.default_rng(seed)
    l0, l1 = (int(x) for x in rng.integers(1, 7, 2))
    k = int(rng.integers(1, 4))
    cache = tlm.init_cache(tm, 2, _REWIND_ML, row_lens=True)
    _, cache = step(cache, rng.integers(0, V, (2, _REWIND_SEED_LEN)))
    lens = torch.tensor([l0, l1], dtype=torch.int32)
    cache["len"] = lens.clone()
    return step, rng, cache, lens, k


def _clone(cache):
    return {"stack": {li: {n: t.clone() for n, t in layer.items()}
                      for li, layer in cache["stack"].items()},
            "len": cache["len"].clone()}


@pytest.mark.parametrize("seed", range(4))
def test_rewind_equals_never_drafted(state, seed):
    """Drafting k tokens into both rows and rewinding leaves the next two
    decodes bitwise those of a cache that never drafted."""
    step, rng, cache, lens, k = _rewind_start(state, seed)
    t_next = rng.integers(0, V, (2, 1))
    t_more = rng.integers(0, V, (2, 1))
    la1, ca = step(_clone(cache), t_next)
    la2, ca = step(ca, t_more)
    _, drafted = step(_clone(cache), rng.integers(0, V, (2, k)))
    assert drafted["len"].tolist() == (lens + k).tolist()
    drafted["len"] = lens.clone()
    lb1, cb = step(drafted, t_next)
    lb2, cb = step(cb, t_more)
    assert torch.equal(la1, lb1) and torch.equal(la2, lb2)
    assert torch.equal(ca["len"], cb["len"])


@pytest.mark.parametrize("seed", range(4))
def test_rewound_rows_verify_as_one_window(state, seed):
    """After a rewind, the k + 1 window read in one forward lands every row
    at frontier + k + 1, and its first position's logits are the one-step
    decode's: bitwise in argmax, within 1e-6 of max |logit| in value (a
    product over 2(k + 1) rows sums in another order than one over 2)."""
    step, rng, cache, lens, k = _rewind_start(state, seed)
    win = rng.integers(0, V, (2, k + 1))
    l_one, _ = step(_clone(cache), win[:, :1])
    _, drafted = step(_clone(cache), win[:, 1:])
    drafted["len"] = lens.clone()
    l_win, verified = step(drafted, win)
    _close(l_win[:, :1], l_one.numpy(), rel=1e-6)
    assert torch.equal(l_win[:, 0].argmax(-1), l_one[:, 0].argmax(-1))
    assert verified["len"].tolist() == (lens + k + 1).tolist()


def _assert_block_conservation(eng, n_blocks):
    free = list(eng._free)
    owned = [b for bl in eng._blocks for b in bl]
    assert len(set(free)) == len(free), free
    assert len(set(owned)) == len(owned), eng._blocks
    assert sorted(free + owned) == list(range(n_blocks)), (free,
                                                           eng._blocks)
    for i, bl in enumerate(eng._blocks):
        row = eng._pages_np[i]
        assert list(row[:len(bl)]) == bl, (i, bl, row)
        assert all(v == -1 for v in row[len(bl):]), (i, bl, row)


@pytest.mark.parametrize("seed", range(6))
def test_paged_pool_conservation_with_speculation(drafty, seed):
    """The reference's block-conservation property with
    ``speculative_k=2``: after EVERY tick each block is owned by exactly
    one of the free list and one live slot, the table mirrors the lists,
    and the pool drains; random arrivals, priorities and deadlines and a
    tight pool force deferral, reclaim and expiry."""
    rng = np.random.default_rng(seed)
    n_blocks = int(rng.choice([3, 4, 6]))
    chunk = int(rng.choice([3, 5, 12]))
    eng = _port(drafty, slots=2, max_len=12, paged=True, block_size=4,
                n_blocks=n_blocks, prefill_chunk=chunk, speculative_k=2)
    n_reqs = int(rng.integers(3, 7))
    reqs = sorted(
        ({"at": int(rng.integers(0, 8)),
          "prompt": rng.integers(0, V, int(rng.integers(2, 9)),
                                 dtype=np.int32),
          "budget": int(rng.integers(1, 6)),
          "priority": int(rng.integers(0, 2)),
          "deadline": (int(rng.integers(2, 6))
                       if rng.random() < 0.3 else None)}
         for _ in range(n_reqs)), key=lambda r: r["at"])
    i = tick = 0
    while i < len(reqs) or eng.has_work():
        while i < len(reqs) and reqs[i]["at"] <= tick:
            eng.submit(reqs[i]["prompt"], max_new_tokens=reqs[i]["budget"],
                       priority=reqs[i]["priority"],
                       deadline_ticks=reqs[i]["deadline"])
            i += 1
        eng.step()
        _assert_block_conservation(eng, n_blocks)
        tick += 1
        assert tick < 400, "engine failed to drain the trace"
    ps = eng.pool_stats()
    assert ps["used_blocks"] == 0 and ps["free_blocks"] == n_blocks, ps
    results = eng.pop_results()
    assert sorted(r.request_id for r in results) == list(range(n_reqs))


def test_engine_speculative_stats_fields():
    """``EngineStats`` keeps the reference's fields, in its order."""
    from repro.launch.engine import EngineStats as JStats
    from repro_torch.launch.engine import EngineStats
    assert [f.name for f in dataclasses.fields(EngineStats)] == \
        [f.name for f in dataclasses.fields(JStats)]

