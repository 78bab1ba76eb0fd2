"""The port's continuous-batching engine slice against the reference.

A 2-layer fp32 model whose K/V block is 128 wide (d_model 256, one KV
head of 128, d_ff 512, r = 16) is built by the reference, its adapters
perturbed with numpy, and the same weights are bridged into the port.

  - the three engine steps (decode, prefill-into-slot, prefill-chunk) on a
    row-length and on a paged cache: logits within 1e-5 of the reference's
    largest |logit|, and the caches they leave behind;
  - the engines on the committed traces of ``BENCH_serve.json``: the same
    greedy streams as the reference ``DecodeEngine(adapters=...)``, the
    same ``stats()`` and ``pool_stats()``, and counters equal to the
    committed schedule models;
  - inside the port: paged streams equal rectangular ones, through chunked
    admission and through a pool small enough to force reclaim;
  - the constructor's refusals and the submit contracts.

The port runs in forced kernel mode, so the paged attention gathers
through the K8 wrapper, which runs its plain version on CPU tensors.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

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
from repro_torch.kernels import paged_gather as tk_paged
from repro_torch import core as tcore
from repro_torch.bridge import flatten_paths, tree_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.config import FORCE_TIER_ENV, DoRAConfig
from repro_torch.launch import steps as tsteps
from repro_torch.launch.engine import DecodeEngine, FINISH_REASONS
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig

ROOT = Path(__file__).resolve().parents[1]
WIDTHS = dict(name="engine-2l", family="dense", num_layers=2, d_model=256,
              num_heads=2, num_kv_heads=1, d_ff=512, vocab_size=512,
              qkv_bias=True, attn_chunk=16)
RANK, ALPHA = 16, 32.0
REL = 1e-5


@pytest.fixture(autouse=True)
def _no_forced_tier(monkeypatch):
    for name in ("REPRO_FORCE_TIER", "REPRO_DORA_MODE", "REPRO_DORA_FUSED",
                 FORCE_TIER_ENV):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def state():
    """(reference model, reference serving tree, port model, port params,
    port serving tree): the reference's build_state with nonzero B,
    m = ||W||·(1 + noise) and nonzero QKV biases, folded (g, gsB) by each
    package's own precompute."""
    jm = JModel(**WIDTHS, dtype=jnp.float32)
    jcfg = JConfig(rank=RANK, alpha=ALPHA, mode="eager")
    params, adapters, _ = build_state(jm, jcfg, 0)
    params = jax.tree_util.tree_map(np.array, params)
    adapters = jax.tree_util.tree_map(np.array, adapters)
    rng = np.random.default_rng(0)
    for name, leaf in flatten_paths(adapters).items():
        if name.endswith("/B"):
            leaf[...] = 0.05 * rng.standard_normal(leaf.shape)
        elif name.endswith("/m"):
            leaf *= 1 + 0.01 * rng.standard_normal(leaf.shape).astype(
                np.float32)
    for name, leaf in flatten_paths(params).items():
        if name.endswith("_bias"):
            leaf[...] = 0.1 * rng.standard_normal(leaf.shape)
    j_serving = jax.jit(jsteps.make_precompute_step(
        jm, jsteps.StepConfig(dora=jcfg), fold_gsb=True))(params, adapters)
    tm = ModelConfig(**WIDTHS, dtype=torch.float32)
    t_params = tree_from_numpy(params)
    t_serving = tsteps.make_precompute_step(tm, _tstep(), fold_gsb=True)(
        t_params, tree_from_numpy(adapters))
    return jm, j_serving, params, tm, t_params, t_serving


@pytest.fixture
def gather_calls(monkeypatch):
    """Counts the K8 wrapper's calls: on CPU tensors it runs its plain
    version, which counts no launch, so the plain version is wrapped."""
    calls = [0]
    plain = tk_paged.paged_gather_plain

    def counted(*a, **k):
        calls[0] += 1
        return plain(*a, **k)
    monkeypatch.setattr(tk_paged, "paged_gather_plain", counted)
    return calls


def _tstep(mode="fused"):
    return tsteps.StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA,
                                             mode=mode))


def _jstep():
    return jsteps.StepConfig(dora=JConfig(rank=RANK, alpha=ALPHA,
                                          mode="eager"))


def _close(got, want, rel=REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = rel * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, f"max err {err} > {tol} ({rel} x max|ref|)"


# ---------------------------------------------------------------------------
# The steps.
# ---------------------------------------------------------------------------

def test_row_length_steps_match_reference(state):
    """Prefill two requests into slots 2 and 0 of a 3-row cache, then two
    batched decodes with every row at its own depth (slot 1 holds no
    request and drifts, as in the engine): logits, per-row lengths and the
    written K/V rows match the reference."""
    jm, j_serving, j_params, tm, t_params, t_serving = state
    slots, max_len = 3, 24
    j_cache = j_init_cache(jm, slots, max_len, row_lens=True)
    t_cache = tlm.init_cache(tm, slots, max_len, row_lens=True)
    j_pre = jax.jit(jsteps.make_prefill_into_slot_step(jm, _jstep(),
                                                       seq=max_len))
    t_pre = tsteps.make_prefill_into_slot_step(tm, _tstep(), seq=max_len)
    rng = np.random.default_rng(1)
    for slot, P in ((2, 7), (0, 12)):
        toks = np.zeros((1, max_len), np.int32)
        toks[0, :P] = rng.integers(0, 512, P)
        j_lg, j_cache = j_pre(j_params, j_serving, j_cache,
                              {"tokens": jnp.asarray(toks),
                               "prompt_len": jnp.int32(P),
                               "slot": jnp.int32(slot)})
        t_lg, t_cache = t_pre(t_params, t_serving, t_cache,
                              {"tokens": torch.as_tensor(toks).long(),
                               "prompt_len": P, "slot": slot})
        _close(t_lg, j_lg)
    j_dec = jax.jit(jsteps.make_decode_step(jm, _jstep(), batch=slots))
    t_dec = tsteps.make_decode_step(tm, _tstep(), batch=slots)
    for _ in range(2):
        toks = rng.integers(0, 512, (slots, 1)).astype(np.int32)
        j_lg, j_cache = j_dec(j_params, j_serving, j_cache,
                              {"tokens": jnp.asarray(toks)})
        t_lg, t_cache = t_dec(t_params, t_serving, t_cache,
                              {"tokens": torch.as_tensor(toks).long()})
        _close(t_lg, j_lg)
    np.testing.assert_array_equal(t_cache["len"].numpy(),
                                  np.asarray(j_cache["len"]))
    assert t_cache["len"].tolist() == [14, 2, 9]
    for slot, n in ((0, 14), (2, 9)):
        for name in ("k", "v"):
            _close(t_cache["stack"]["l0"][name][:, slot, :n],
                   np.asarray(j_cache["stack"]["l0"][name])[:, slot, :n])


def test_paged_steps_match_reference(state, gather_calls):
    """On a paged cache with an out-of-order block table: a 21-token
    prompt admitted in chunks of 8 (the final one re-anchored at P - C)
    into slot 1, with a batched decode between the chunks, then decodes:
    logits, lengths and the pools' allocated blocks match the reference.
    The port's chunk and decode steps gather through the K8 wrapper, twice
    per layer."""
    jm, j_serving, j_params, tm, t_params, t_serving = state
    slots, max_len, bs, n_blocks, C = 2, 32, 4, 12, 8
    pages = np.full((slots, max_len // bs), -1, np.int32)
    pages[1, :6] = [9, 2, 7, 0, 11, 4]          # covers positions [0, 24)
    pages[0, :2] = [5, 3]
    j_cache = j_init_cache(jm, slots, max_len, row_lens=True,
                           block_size=bs, n_blocks=n_blocks)
    j_cache["pages"] = jnp.asarray(pages)
    t_cache = tlm.init_cache(tm, slots, max_len, row_lens=True,
                             block_size=bs, n_blocks=n_blocks)
    t_cache["pages"] = torch.as_tensor(pages)
    j_chunk = jax.jit(jsteps.make_prefill_chunk_step(jm, _jstep(), chunk=C))
    t_chunk = tsteps.make_prefill_chunk_step(tm, _tstep(), chunk=C)
    j_dec = jax.jit(jsteps.make_decode_step(jm, _jstep(), batch=slots))
    t_dec = tsteps.make_decode_step(tm, _tstep(), batch=slots)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, 512, 21).astype(np.int32)
    n_steps = 0
    for start, c_len in ((0, 8), (8, 8), (13, 8)):
        toks = np.zeros((1, C), np.int32)
        toks[0, :c_len] = prompt[start:start + c_len]
        j_lg, j_cache = j_chunk(j_params, j_serving, j_cache,
                                {"tokens": jnp.asarray(toks),
                                 "slot": jnp.int32(1),
                                 "start": jnp.int32(start),
                                 "chunk_len": jnp.int32(c_len)})
        t_lg, t_cache = t_chunk(t_params, t_serving, t_cache,
                                {"tokens": torch.as_tensor(toks).long(),
                                 "slot": 1, "start": start,
                                 "chunk_len": c_len})
        _close(t_lg, j_lg)
        toks = rng.integers(0, 512, (slots, 1)).astype(np.int32)
        j_lg, j_cache = j_dec(j_params, j_serving, j_cache,
                              {"tokens": jnp.asarray(toks)})
        t_lg, t_cache = t_dec(t_params, t_serving, t_cache,
                              {"tokens": torch.as_tensor(toks).long()})
        _close(t_lg, j_lg)
        n_steps += 2
    assert gather_calls[0] == 2 * WIDTHS["num_layers"] * n_steps
    np.testing.assert_array_equal(t_cache["len"].numpy(),
                                  np.asarray(j_cache["len"]))
    # Slot 1 holds the prompt at [0, 21) and the last decode's K/V at 21.
    live = pages[1, :6]
    for name in ("k", "v"):
        got = t_cache["stack"]["l0"][name][:, live]
        want = np.asarray(j_cache["stack"]["l0"][name])[:, live]
        _close(got.reshape(got.shape[0], -1, *got.shape[3:])[:, :22],
               want.reshape(want.shape[0], -1, *want.shape[3:])[:, :22])


def test_paged_cache_shapes_and_refusals():
    tm = ModelConfig(**WIDTHS, dtype=torch.float32)
    shapes = tlm.cache_shapes(tm, 3, 32, row_lens=True, block_size=8)
    assert shapes["stack"]["l0"]["k"][0] == (2, 12, 8, 1, 128)
    assert shapes["pages"] == ((3, 4), torch.int32)
    assert shapes["len"] == ((3,), torch.int32)
    cache = tlm.init_cache(tm, 3, 32, row_lens=True, block_size=8,
                           n_blocks=5)
    assert tuple(cache["stack"]["l0"]["v"].shape) == (2, 5, 8, 1, 128)
    assert (cache["pages"] == -1).all() and cache["len"].tolist() == [0] * 3
    with pytest.raises(ValueError, match="row_lens=True"):
        tlm.cache_shapes(tm, 3, 32, block_size=8)
    with pytest.raises(ValueError, match="multiple"):
        tlm.cache_shapes(tm, 3, 30, row_lens=True, block_size=8)


def test_chunked_attention_refuses_per_row_offsets():
    from repro_torch.models import layers as tlayers
    q = torch.zeros(2, 4, 2, 8)
    k = torch.zeros(2, 16, 1, 8)
    with pytest.raises(NotImplementedError, match="per-row"):
        tlayers.attention_core(q, k, k, offset=torch.tensor([0, 3]),
                               chunk=4)


# ---------------------------------------------------------------------------
# The engines on the committed traces.
# ---------------------------------------------------------------------------

def _arrival_trace(*, n_requests, mean_interarrival, prompt_len, gen_lens,
                   seed):
    """``benchmarks/serve_bench.py::make_arrival_trace``, as
    (arrival_step, prompt_len, gen_len) triples."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for _ in range(n_requests):
        t += rng.exponential(mean_interarrival)
        out.append((int(t), int(prompt_len), int(rng.choice(gen_lens))))
    return out


def _bench(section):
    """(trace, engine kwargs, committed schedule model) of a
    ``BENCH_serve.json`` section; the paged trace gets its one long prompt
    spliced in, as ``make_longcontext_trace`` does."""
    sec = json.loads((ROOT / "BENCH_serve.json").read_text())[section]
    tp = sec["trace"]
    trace = _arrival_trace(n_requests=tp["n_requests"],
                           mean_interarrival=tp["mean_interarrival"],
                           prompt_len=tp["prompt_len"],
                           gen_lens=tuple(tp["gen_lens"]), seed=tp["seed"])
    kw = {"slots": tp["slots"], "max_len": tp["max_len"]}
    if section == "continuous":
        return trace, kw, sec["engine_model"]
    long = (tp["long_arrival"], tp["long_prompt_len"], tp["long_gen_len"])
    at = next((i for i, r in enumerate(trace) if r[0] > long[0]),
              len(trace))
    trace.insert(at, long)
    kw.update(paged=True, block_size=tp["block_size"],
              n_blocks=tp["n_blocks"], prefill_chunk=tp["prefill_chunk"])
    return trace, kw, sec["schedule_model"]


def _drive(engine, trace, prompts, **submit_kw):
    """Submit each request as its arrival step comes due and tick once per
    step; returns {request_id: [token, ...]} as on_token streamed them."""
    streams: dict[int, list[int]] = {}

    def on_token(rid, tok):
        streams.setdefault(rid, []).append(int(tok))

    i, step = 0, 0
    while i < len(trace) or engine.has_work():
        while i < len(trace) and trace[i][0] <= step:
            kw = {k: v[i] for k, v in submit_kw.items()}
            engine.submit(prompts[i], max_new_tokens=trace[i][2], key_id=i,
                          **kw)
            i += 1
        engine.step(on_token)
        step += 1
    return streams


def _prompts(trace, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, r[1], dtype=np.int32) for r in trace]


def _port_engine(state, mode="fused", **kw):
    _, _, _, tm, t_params, t_serving = state
    return DecodeEngine(tm, _tstep(mode), t_params, adapters=t_serving,
                        device="cpu", **kw)


@pytest.mark.parametrize("section", ["continuous", "paged"])
def test_engine_matches_reference_on_committed_trace(state, section,
                                                     gather_calls):
    jm, j_serving, j_params, *_ = state
    trace, kw, _ = _bench(section)
    prompts = _prompts(trace)
    ref = JEngine(jm, _jstep(), j_params, adapters=j_serving, **kw)
    want = _drive(ref, trace, prompts)
    port = _port_engine(state, **kw)
    got = _drive(port, trace, prompts)
    assert got == want
    assert port.stats().as_dict() == ref.stats().as_dict()
    steps = port.device_steps()
    if section == "paged":
        assert port.pool_stats() == ref.pool_stats()
        assert port.pool_stats()["used_blocks"] == 0
        assert steps["prefill_into_slot"] == 0
    else:
        assert steps["prefill_chunk"] == 0
        assert steps["prefill_into_slot"] == len(trace)
    assert gather_calls[0] == 2 * WIDTHS["num_layers"] * (
        steps["decode"] + steps["prefill_chunk"]) * (section == "paged")


@pytest.mark.parametrize("section", ["continuous", "paged"])
def test_engine_counters_equal_committed_models(state, section):
    """The port's counters equal ``BENCH_serve.json``'s deterministic
    schedule models: 41 / 35 / 12 / 88 / 76 for the rectangular engine;
    41 / 35 / 13 / 94 / 81 with a peak of 13 blocks for the paged one."""
    trace, kw, model = _bench(section)
    engine = _port_engine(state, **kw)
    _drive(engine, trace, _prompts(trace))
    st = engine.stats()
    for field in ("steps", "decode_steps", "prefills", "generated_tokens",
                  "slot_steps"):
        assert getattr(st, field) == model[field], field
    assert st.mean_occupancy == model["mean_occupancy"]
    if section == "paged":
        ps = engine.pool_stats()
        assert ps["peak_used_blocks"] == model["peak_used_blocks"] == 13
        assert ps["used_blocks"] == 0
        assert engine.device_steps()["prefill_chunk"] == 18


def test_priorities_and_deadlines_match_reference(state):
    """Priority preemption (resumed as a continuation), a queued timeout
    and a mid-decode timeout, on a 2-slot engine: the same results, finish
    reasons and counters as the reference."""
    jm, j_serving, j_params, *_ = state
    trace = [(0, 6, 9), (0, 5, 9), (1, 4, 5), (2, 7, 3), (2, 5, 6),
             (3, 6, 4)]
    prompts = _prompts(trace, seed=4)
    submit = {"priority": [0, 0, 2, 0, 1, 0],
              "deadline_ticks": [None, None, None, 3, None, 6]}
    out = {}
    for name, engine in (
            ("ref", JEngine(jm, _jstep(), j_params, adapters=j_serving,
                            slots=2, max_len=16)),
            ("port", _port_engine(state, slots=2, max_len=16))):
        streams = _drive(engine, trace, prompts, **submit)
        res = [(r.request_id, r.tokens.tolist(), r.finish_reason,
                r.admitted_step, r.finished_step, r.preempted)
               for r in engine.pop_results()]
        out[name] = (streams, res, engine.stats().as_dict())
    assert out["port"] == out["ref"]
    st = out["port"][2]
    assert st["preemptions"] >= 1 and st["timeouts"] == 2
    reasons = {r[2] for r in out["port"][1]}
    assert reasons <= set(FINISH_REASONS) and "timeout" in reasons


# ---------------------------------------------------------------------------
# Inside the port: paged == rectangular.
# ---------------------------------------------------------------------------

_TRACE = [(1, 8, 8), (1, 8, 6), (1, 8, 4), (4, 8, 10), (6, 8, 10),
          (11, 8, 8), (23, 8, 6), (23, 8, 10), (28, 8, 8), (30, 8, 4),
          (32, 8, 4), (32, 8, 10)]


@pytest.mark.parametrize("paged_kw", [
    {"block_size": 6},                          # chunk 6 < P = 8
    {"block_size": 6, "prefill_chunk": 9},      # one chunk per prompt
    {"block_size": 6, "n_blocks": 8},           # deferral + reclaim
], ids=["chunked", "one-chunk", "small-pool"])
def test_paged_streams_equal_rectangular(state, paged_kw):
    prompts = _prompts(_TRACE, seed=0)
    rect = _port_engine(state, slots=4, max_len=18)
    paged = _port_engine(state, slots=4, max_len=18, paged=True, **paged_kw)
    want = _drive(rect, _TRACE, prompts)
    got = _drive(paged, _TRACE, prompts)
    assert got == want
    ps = paged.pool_stats()
    assert ps["used_blocks"] == 0 and ps["per_slot_blocks"] == [0] * 4
    assert 0 < ps["peak_used_blocks"] <= ps["n_blocks"]
    st_r, st_p = rect.stats(), paged.stats()
    assert st_p.generated_tokens == st_r.generated_tokens
    if "prefill_chunk" in paged_kw:
        for field in ("steps", "decode_steps", "prefills", "slot_steps"):
            assert getattr(st_p, field) == getattr(st_r, field), field
    if "n_blocks" in paged_kw:
        assert st_p.preemptions > 0


def test_lifecycle_eos_budget_and_max_len(state):
    """EOS retires early and hands the row on; a budget past the cache
    bound stops at max_len - P; a one-token budget never takes a decode
    row; each request's tokens equal serving it alone."""
    rng = np.random.default_rng(5)
    p0, p1 = (rng.integers(0, 512, n, dtype=np.int32) for n in (5, 4))
    alone = _port_engine(state, slots=1, max_len=14)
    alone.submit(p0, max_new_tokens=6)
    (ref,) = alone.run()
    eos = int(ref.tokens[2])
    stop = int(np.where(ref.tokens == eos)[0][0])
    engine = _port_engine(state, slots=1, max_len=14)
    engine.submit(p0, max_new_tokens=6, eos_id=eos)
    engine.submit(p1, max_new_tokens=50)
    engine.submit(p1, max_new_tokens=1)
    r0, r1, r2 = engine.run()
    assert r0.finish_reason == "eos"
    np.testing.assert_array_equal(r0.tokens, ref.tokens[:stop + 1])
    assert r1.finish_reason == "max_len" and r1.tokens.shape == (10,)
    assert r1.admitted_step > r0.finished_step
    assert r2.finish_reason == "length" and r2.tokens.shape == (1,)
    np.testing.assert_array_equal(r2.tokens, r1.tokens[:1])


def test_temperature_sampling_is_reproducible(state):
    runs = []
    for _ in range(2):
        engine = _port_engine(state, slots=2, max_len=16, temperature=0.8,
                              seed=3, paged=True, block_size=4)
        runs.append(_drive(engine, _TRACE[:4], _prompts(_TRACE[:4])))
    assert runs[0] == runs[1]
    greedy = _drive(_port_engine(state, slots=2, max_len=16), _TRACE[:4],
                    _prompts(_TRACE[:4]))
    assert runs[0] != greedy


# ---------------------------------------------------------------------------
# Contracts.
# ---------------------------------------------------------------------------

def _one_rank_mesh():
    from repro_torch.launch.mesh import make_debug_mesh
    return make_debug_mesh(1, 1, device="cpu", backend="gloo")


@pytest.mark.parametrize("kw,item", [
    ({"speculative_k": 2}, "multi-device"),
])
def test_later_slices_are_refused(state, kw, item):
    """Under a mesh (a real one-rank gloo mesh) the engine runs what
    ``kw`` asks for, speculation (k = 2), as on no mesh: rectangular and
    paged, its streams, results, stats and device steps equal the no-mesh
    engine's bit for bit. What stays refused on a mesh is point 2 of
    ROADMAP queue 1 item 6, second half (``item``: multi-device Mamba and
    MoE stacks), refused once, by ``check_mesh_supported``. Slots of two
    handles: two perturbed tenants, admitted beside each other,
    rectangular and paged, give the no-mesh engine's streams, results and
    stats bit for bit, and the tenants' streams differ."""
    from repro_torch.configs import get_config

    one = _one_rank_mesh()
    trace = _TRACE[:6]
    for geo in ({}, dict(paged=True, block_size=4, prefill_chunk=4)):
        runs = []
        for m in (one, None):
            engine = _port_engine(state, slots=2, max_len=16, mesh=m,
                                  **kw, **geo)
            streams = _drive(engine, trace, _prompts(trace))
            runs.append((streams, [(r.request_id, r.tokens.tolist(),
                                    r.finish_reason)
                                   for r in engine.pop_results()],
                         engine.stats().as_dict(), engine.device_steps()))
        assert runs[0] == runs[1]
        assert runs[0][3]["verify"] > 0
    for arch in ("falcon-mamba-7b", "qwen2-moe-a2.7b"):
        with pytest.raises(NotImplementedError, match=item) as err:
            tsteps.make_decode_step(get_config(arch, smoke=True), _tstep(),
                                    one, batch=2)
        assert "point 2" in str(err.value)
    _, _, _, tm, t_params, _ = state
    scfg = _tstep()
    gen = torch.Generator().manual_seed(0)
    tenants = {}
    for name in ("a", "b"):
        ad = tlm.init_adapters(gen, tm, t_params, scfg.dora)
        for path, leaf in flatten_paths(ad).items():
            if path.endswith("/B"):
                leaf.copy_(0.05 * torch.randn(leaf.shape, generator=gen))
        tenants[name] = ad
    trace = [(0, 4, 4), (0, 5, 4), (1, 6, 3), (2, 3, 4)]
    prompts = _prompts(trace, seed=9)
    owners = ["a", "b", "b", "a"]
    runs = {}
    for paged in (False, True):
        geo = dict(paged=True, block_size=4, prefill_chunk=4) if paged \
            else {}
        for m in (one, None):
            cache = (tcore.AdapterStateCache.for_serving(tm, scfg, mesh=m)
                     if m is not None else
                     tcore.AdapterStateCache.for_serving(tm, scfg,
                                                         device="cpu"))
            for name, ad in tenants.items():
                cache.register(name, ad)
            engine = DecodeEngine(tm, scfg, t_params, adapter_cache=cache,
                                  slots=2, max_len=16, mesh=m,
                                  device=None if m else "cpu", **geo)
            streams = _drive(engine, trace, prompts, adapter=owners)
            runs[paged, m is None] = (
                streams, [(r.request_id, r.tokens.tolist(), r.finish_reason)
                          for r in engine.pop_results()],
                engine.stats().as_dict(), engine.step_signatures())
        assert runs[paged, False] == runs[paged, True]
        assert any(k != "None" for k in runs[paged, False][3]["decode"])
    assert runs[False, True][0] == runs[True, True][0]
    alone = DecodeEngine(tm, scfg, t_params, adapters=tsteps.
                         make_precompute_step(tm, scfg, fold_gsb=True)(
                             t_params, tenants["a"]), slots=2, max_len=16,
                         device="cpu")
    assert _drive(alone, trace[1:2], prompts[1:2]) != {
        0: runs[False, True][0][1]}


def test_mesh_engine_refuses_a_raw_tree_and_a_foreign_cache(state):
    """Under a mesh a fixed adapter tree must be the mesh precompute's
    serving state (a raw leaf is refused, naming it), and a cache must be
    keyed for that mesh (one keyed for no mesh is refused)."""
    _, _, _, tm, t_params, _ = state
    scfg = _tstep()
    one = _one_rank_mesh()
    raw = tlm.init_adapters(torch.Generator().manual_seed(0), tm, t_params,
                            scfg.dora)
    with pytest.raises(ValueError, match="stack/l0/.*has no 'g'"):
        DecodeEngine(tm, scfg, t_params, adapters=raw, slots=2, max_len=16,
                     mesh=one)
    foreign = tcore.AdapterStateCache.for_serving(tm, scfg, device="cpu")
    with pytest.raises(ValueError, match="keyed for sharding"):
        DecodeEngine(tm, scfg, t_params, adapter_cache=foreign, slots=2,
                     max_len=16, mesh=one)
    served = tsteps.make_precompute_step(tm, scfg, one, fold_gsb=True)(
        t_params, raw)
    engine = DecodeEngine(tm, scfg, t_params, adapters=served, slots=2,
                          max_len=16, mesh=one)
    assert engine.device == torch.device("cpu")


def test_constructor_and_submit_contracts(state):
    _, _, _, tm, t_params, t_serving = state
    with pytest.raises(ValueError, match="precomputed"):
        DecodeEngine(tm, _tstep(), t_params, slots=2, max_len=16,
                     device="cpu")
    with pytest.raises(ValueError, match="paged"):
        _port_engine(state, slots=2, max_len=18, block_size=6)
    with pytest.raises(ValueError, match="multiple"):
        _port_engine(state, slots=2, max_len=18, paged=True, block_size=5)
    with pytest.raises(ValueError, match="n_blocks"):
        _port_engine(state, slots=2, max_len=18, paged=True, block_size=6,
                     n_blocks=2)
    with pytest.raises(ValueError, match="live on cpu"):
        DecodeEngine(tm, _tstep(), t_params, slots=2, max_len=16,
                     adapters=t_serving, device="meta")
    for arch_kw, match in (({"ssm": True}, "integrate every processed"),
                           ({"moe": True}, "MoE")):
        with pytest.raises(NotImplementedError, match=match):
            DecodeEngine(dataclasses.replace(tm, **arch_kw), _tstep(),
                         t_params, slots=2, max_len=16, adapters=t_serving,
                         device="cpu")
    engine = _port_engine(state, slots=1, max_len=6)
    with pytest.raises(ValueError, match="P \\+ 1 <= max_len"):
        engine.submit(np.zeros(6, np.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match="max_new_tokens"):
        engine.submit(np.zeros(3, np.int32), max_new_tokens=0)
    with pytest.raises(ValueError, match="fixed adapter tree"):
        engine.submit(np.zeros(3, np.int32), max_new_tokens=2,
                      adapter="t0")
    with pytest.raises(ValueError, match="paged engine"):
        engine.pool_stats()


def test_engine_defaults_to_the_card():
    """Without ``device`` the engine runs on the card and raises here."""
    tm = get_config("qwen2-7b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA unavailable"):
        DecodeEngine(tm, _tstep(), {"embed": torch.zeros(1)}, slots=1,
                     max_len=8, adapters={})
