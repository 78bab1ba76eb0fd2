"""The port across gloo CPU ranks against the reference's single-device
functions.

Each world size (2 and 4 ranks) is one spawn (``tests/torch_dist_ranks.py``,
which imports no ``jax``), started before the reference runs and joined
after it under a timeout of its own; its cases are then read by the
tests below. The reference runs in this process on numpy inputs; the
ranks get copies of the same arrays, never the arrays the reference
holds.

Held, in fp32 (tolerances of the largest magnitude, never elementwise):
``factored_norm_sharded`` (s != 0, s = 0, with and without the summed
base term, on the kernel wrappers and on the eager terms) within 1e-5 of
the reference's ``factored_norm`` and of ``norm_reference_fp64``, and
its three sums' bytes; the shard-local compose's delta, d_base, d_h, d_B
and d_g within 1e-5 of the reference's single-device
``fused_compose_mm`` VJP (Pallas in interpret mode) for the TP, SP and
2-D layouts, its forward with no collective; a 2-layer dense LM (d_model
512, 4 heads, 2 KV heads, d_ff 1024, vocab 512, QKV bias, r = 16) on
meshes (1, 2), (2, 1) and (2, 2), by every compose route, its loss within
1e-5 relative of the reference's ``make_train_step`` and its gathered
adapter gradients within 1e-4 of the reference's; the mesh prefill's
logits and cached K against the reference's prefill; the cross-pod
gradient sync on a (pod, data) mesh against the reference's int8
error-feedback compression. Single-tenant serving on the same meshes by
the ``mm`` and ``eager`` routes: the mesh precompute's gathered g and
gsB (folded and not) within 1e-5 of max of the reference's
``make_precompute_step``; ``generate(mesh=)`` (padded prefill, 4 greedy
tokens) with every step's logits within 1e-5 of max |logit| of the
reference's ``generate(return_logits=True)``, its tokens equal after a
least top-2 gap of GAP_MIN at each step, the gathered K/V after the
prefill and after the last decode step within 1e-5 of the reference's
cache; temperature sampling equal to the port's single-card
``generate``; a handle through ``AdapterStateCache.for_serving(mesh=)``
serving the same tokens, a cache keyed for another mesh refused; and
``mesh_fingerprint`` against the reference's.

The continuous-batching engine across the same meshes, in a spawn of its
own per world size (under ``ENGINE_TIMEOUT_S``), on the same model, by
the ``mm`` route: ``DecodeEngine(mesh=)`` with the rectangular cache on
the committed ``BENCH_serve.json`` ``continuous`` trace and with the
paged cache on its ``paged`` trace, each with a fixed serving tree of the
mesh precompute and with a one-handle cache of
``AdapterStateCache.for_serving(mesh=)``; the priority and deadline trace
of ``tests/test_torch_engine.py`` on (2, 2); ``EngineServer(mesh=).run``.
Their streams, ``stats()`` and ``pool_stats()`` equal the reference's
single-device ``DecodeEngine`` and ``EngineServer`` and the committed
schedule models, K8's plain version runs twice a layer in every chunk
and decode step of each rank, and every rank returns rank 0's results.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import factored_norm as jnorm
from repro.core.config import DoRAConfig as JConfig
from repro.kernels import ops as jops
from repro.launch.steps import StepConfig as JStep
from repro.launch.steps import cross_entropy as jcross_entropy
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro.launch.steps import make_train_step as jmake_train_step
from repro.core.adapter_cache import mesh_fingerprint as jmesh_fingerprint
from repro.launch.serve import generate as jgenerate
from repro.launch.steps import make_decode_step as jmake_decode_step
from repro.launch.steps import make_precompute_step as jmake_precompute_step
from repro.launch.train import build_state as jbuild_state
from repro.models import forward as jforward
from repro.models.config import ModelConfig as JModel
from repro.optim import OptimizerConfig as JOpt
from repro.optim import compression as jcomp
from repro_torch.bridge import flatten_paths
from repro_torch.core.adapter_cache import mesh_fingerprint

import torch_dist_ranks as R
from repro import core as jcore
from repro.launch.engine import DecodeEngine as JEngine
from repro.launch.serve import EngineServer as JServer
from repro.launch.serve import MultiTenantServer as JMTServer
from repro.launch.serve import Request as JRequest
from test_torch_engine import _bench, _drive, _prompts

WIDTHS = dict(name="dist-2l", family="dense", num_layers=2, d_model=512,
              num_heads=4, num_kv_heads=2, d_ff=1024, vocab_size=512,
              qkv_bias=True)
RANK, ALPHA = 16, 32.0
BATCH, SEQ, LOSS_TOKENS = 2, 16, 8
OPTIM = dict(lr=1e-2, warmup_steps=2, total_steps=3, eps=1e-4)
ROUTES = {"mm": dict(mode="fused", mm_fused_max_rank=128),
          "elementwise": dict(mode="fused", compose_matmul_fused=False),
          "eager": dict(mode="eager")}
TRAIN = {2: [((1, 2), "mm"), ((1, 2), "elementwise"), ((1, 2), "eager"),
             ((2, 1), "mm")],
         4: [((2, 2), "mm"), ((2, 2), "eager")]}
COMPOSE = {2: {"tp": (1, 2, (None, "model")), "sp": (1, 2, ("model", None))},
           4: {"tp": (2, 2, (None, ("data", "model"))),
               "sp": (2, 2, ("model", None)),
               "2d": (2, 2, ("data", "model"))}}
NORM = {2: ((1, 2), ("model",)), 4: ((2, 2), ("data", "model"))}
PREFILL = {2: (1, 2), 4: (2, 2)}
SERVE = {2: [((1, 2), "mm"), ((1, 2), "eager"), ((2, 1), "mm"),
             ((2, 1), "eager")],
         4: [((2, 2), "mm"), ((2, 2), "eager")]}
PROMPT, GEN, MAX_LEN = 12, 4, SEQ
TEMPERATURE, SAMPLE_SEED = 0.8, 7
# Each greedy step's least top-1 - top-2 gap, over its max |logit|: ten
# times the logits' tolerance, so equal tokens are a check and not luck.
GAP_MIN = 1e-4
# The engine's meshes, a spawn of their own per world size.
ENGINE = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}
ENGINE_TIMEOUT_S = 240
# tests/test_torch_engine.py test_priorities_and_deadlines_match_reference
PRIORITY_TRACE = [(0, 6, 9), (0, 5, 9), (1, 4, 5), (2, 7, 3), (2, 5, 6),
                  (3, 6, 4)]
PRIORITY_SUBMIT = {"priority": [0, 0, 2, 0, 1, 0],
                   "deadline_ticks": [None, None, None, 3, None, 6]}
# EngineServer: mixed prompt lengths through the paged engine.
SERVER_LENS, SERVER_GEN = (9, 5, 12, 7, 30, 4), 6
SERVER_KW = dict(slots=4, max_len=48, paged=True, block_size=8,
                 n_blocks=12, prefill_chunk=8)
# Static tenant groups on the same meshes (the mm route's serving cases
# and the engine spawns): three tenants (B and m perturbed per tenant),
# six requests with interleaved owners (the server's sort permutes them;
# rows 0-2 share one prompt under the three tenants). Batch 6 at data 2
# puts tenant 1's group across the replica boundary and tenants 0 and 2
# each on one replica only.
MT_TENANTS = 3
MT_OWNERS = (2, 0, 1, 0, 2, 1)
MT_GROUPS = ((0, 2), (2, 2), (4, 2))
# Dynamic grouping and speculation across the mesh (the engine spawns):
# the committed fleet trace over five tenants (the first three MT's), at
# its 3 slots and at 4, whose rows split over data; the committed
# speculative trace at k = 3. Dynamic == static within FLEET_INSIDE of
# max |logit| (tests/test_torch_fleet.py's bound inside the port).
FLEET_TENANTS = 5
FLEET_INSIDE = 2e-6
# The paged geometry of both traces (max_len 18): the default blocks of
# 9 and chunks of 18, which the model axis splits (chunks of 9 it does
# not), so that each prompt of 8 enters in one chunk as with the default
# chunk and the schedule is the committed one.
PAGED_GEO = {"paged": True, "prefill_chunk": 18}


def _max_rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


# --- the inputs and the reference's results ---------------------------------

def _norm_inputs():
    rng = np.random.default_rng(3)
    d_out, d_in = 256, 512
    W = (rng.standard_normal((d_out, d_in)) / np.sqrt(d_in)).astype(
        np.float32)
    A = (rng.uniform(-1, 1, (RANK, d_in)) / np.sqrt(d_in)).astype(np.float32)
    B = (0.05 * rng.standard_normal((d_out, RANK))).astype(np.float32)
    return {"W": W, "A": A, "B": B, "s": ALPHA / np.sqrt(RANK),
            "base_sq": (W.astype(np.float64) ** 2).sum(1).astype(
                np.float32)}


def _compose_inputs():
    rng = np.random.default_rng(4)
    m, n = 64, 512
    return {"base": rng.standard_normal((m, n)).astype(np.float32),
            "h": (0.5 * rng.standard_normal((m, RANK))).astype(np.float32),
            "B": (0.05 * rng.standard_normal((n, RANK))).astype(np.float32),
            "g": (1 + 0.05 * rng.standard_normal(n)).astype(np.float32),
            "dy": rng.standard_normal((m, n)).astype(np.float32),
            "s": 0.7}


def _compression_inputs():
    """examples/grad_compression_dp.py's toy: d = 512, x of 16 rows."""
    rng = np.random.default_rng(0)
    d = 512
    return {"w": (rng.normal(size=(d,)) * 0.1).astype(np.float32),
            "t": rng.normal(size=(d,)).astype(np.float32),
            "x": (rng.normal(size=(16, d)) ** 2).astype(np.float32)}


def _model_state():
    """The reference's build_state with nonzero B, m = ||W||·(1 + noise)
    and nonzero QKV biases, as numpy trees."""
    jm = JModel(**WIDTHS, dtype=jnp.float32)
    params, adapters, _ = map(_np_tree, jbuild_state(
        jm, JConfig(rank=RANK, alpha=ALPHA), 0))
    rng = np.random.default_rng(5)
    for name, leaf in flatten_paths(adapters).items():
        if name.endswith("/B"):
            leaf[...] = 0.05 * rng.standard_normal(leaf.shape)
        elif name.endswith("/m"):
            leaf *= 1 + 0.01 * rng.standard_normal(leaf.shape).astype(
                np.float32)
    for name, leaf in flatten_paths(params).items():
        if name.endswith("_bias"):
            leaf[...] = 0.1 * rng.standard_normal(leaf.shape)
    toks = np.random.default_rng(6).integers(
        0, WIDTHS["vocab_size"], (BATCH, SEQ + 1)).astype(np.int32)
    return jm, params, adapters, toks[:, :-1], toks[:, 1:]


@pytest.fixture(scope="module")
def inputs():
    """numpy inputs of every case: the ranks get copies of these."""
    state = _model_state()[1:]
    return {"norm": _norm_inputs(), "compose": _compose_inputs(),
            "state": state, "compression": _compression_inputs(),
            "tenants": _tenants(state[1]),
            "fleet_tenants": _tenants(state[1], FLEET_TENANTS),
            "spec": _spec_inputs(state[0], state[1])}


def _tenants(adapters, n=MT_TENANTS):
    """``n`` copies of the adapters, each with its own B and m
    perturbation (numpy)."""
    out = []
    for t in range(n):
        rng = np.random.default_rng(20 + t)
        ad = _np_tree(adapters)
        for name, leaf in flatten_paths(ad).items():
            if name.endswith("/B"):
                leaf[...] = 0.05 * rng.standard_normal(leaf.shape)
            elif name.endswith("/m"):
                leaf *= 1 + 0.01 * rng.standard_normal(leaf.shape).astype(
                    np.float32)
        out.append(ad)
    return out


def _mt_prompts():
    rng = np.random.default_rng(12)
    prompts = rng.integers(0, WIDTHS["vocab_size"],
                           (len(MT_OWNERS), PROMPT)).astype(np.int32)
    prompts[1:MT_TENANTS] = prompts[0]
    return prompts


@pytest.fixture(scope="module")
def spawned(inputs, tmp_path_factory):
    """Both world sizes' ranks, started before the reference runs."""
    handles = {w: R.Ranks(w, _cases(w, inputs),
                          tmp_path_factory.mktemp(f"world{w}"))
               for w in (2, 4)}
    yield handles
    for h in handles.values():
        h.kill()


@pytest.fixture(scope="module")
def reference(inputs, spawned):
    """The reference's single-device results, computed while the ranks
    run."""
    ni = inputs["norm"]
    W, A, B = (jnp.asarray(ni[k]) for k in ("W", "A", "B"))
    norm = {}
    for s in (ni["s"], 0.0):
        for cache in (None, jnp.asarray(ni["base_sq"])):
            norm[(s != 0.0, cache is not None)] = np.asarray(
                jnorm.factored_norm(W, A, B, s, base_sq_cache=cache))
    with jax.enable_x64(True):
        fp64 = {s != 0.0: np.asarray(jnorm.norm_reference_fp64(
            jnp.asarray(ni["W"], jnp.float64),
            jnp.asarray(ni["A"], jnp.float64),
            jnp.asarray(ni["B"], jnp.float64), s))
            for s in (ni["s"], 0.0)}

    ci = inputs["compose"]
    args = tuple(jnp.asarray(ci[k]) for k in ("base", "h", "B", "g"))
    delta, vjp = jax.vjp(lambda b, h, bb, g: jops.fused_compose_mm(
        b, h, bb, g, ci["s"], interpret=True), *args)
    grads = vjp(jnp.asarray(ci["dy"]))
    compose = {"delta": np.asarray(delta),
               **{k: np.asarray(v) for k, v in zip(
                   ("d_base", "d_h", "d_B", "d_g"), grads)}}

    params, adapters, tokens, labels = inputs["state"]
    jm = JModel(**WIDTHS, dtype=jnp.float32)
    jcfg = JConfig(rank=RANK, alpha=ALPHA, mode="eager")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ja = jax.tree_util.tree_map(jnp.asarray, adapters)

    def loss_fn(a):
        logits, _, aux = jforward(jm, jp, a, jcfg, tokens=jnp.asarray(tokens),
                                  training=True, loss_slice=LOSS_TOKENS)
        return jcross_entropy(logits, jnp.asarray(labels)[:, -LOSS_TOKENS:]) \
            + aux

    loss, jg = jax.value_and_grad(loss_fn)(ja)
    step = jmake_train_step(jm, JStep(dora=jcfg, optim=JOpt(**OPTIM),
                                      loss_tokens=LOSS_TOKENS), None,
                            batch=BATCH, seq=SEQ)
    from repro.optim import adamw_init
    _, _, met = step(jp, ja, adamw_init(ja),
                     {"tokens": jnp.asarray(tokens),
                      "labels": jnp.asarray(labels)})
    last, cache = jmake_prefill_step(jm, JStep(dora=jcfg), None, batch=BATCH,
                                     seq=SEQ)(jp, ja, {"tokens": jnp.asarray(
                                         tokens)})
    return {"norm": norm, "fp64": fp64, "compose": compose,
            "loss": float(loss), "grads": flatten_paths(_np_tree(jg)),
            "step": {k: float(met[k]) for k in ("loss", "grad_norm")},
            "prefill": (np.asarray(last),
                        np.asarray(cache["stack"]["l0"]["k"])),
            "serve": _reference_serving(jm, jcfg, jp, ja, tokens),
            "mt": _reference_multitenant(jm, jcfg, jp, inputs["tenants"])}


def _reference_multitenant(jm, jcfg, jp, tenants):
    """The reference's single-device MultiTenantServer on the three
    tenants: tokens and per-step logits."""
    jscfg = JStep(dora=jcfg)
    cache = jcore.AdapterStateCache.for_serving(jm, jscfg)
    for t, ad in enumerate(tenants):
        cache.register(f"t{t}", _np_tree(ad))
    reqs = [JRequest(q, f"t{t}") for q, t in zip(_mt_prompts(), MT_OWNERS)]
    toks, logits = JMTServer(jm, jscfg, jp, cache=cache).serve(
        reqs, gen_len=GEN, max_len=MAX_LEN, return_logits=True)
    return {"tokens": np.asarray(toks),
            "logits": [np.asarray(x) for x in logits]}


def _reference_serving(jm, jcfg, jp, ja, tokens):
    """The reference's single-device serving: the precompute's g and gsB
    (folded and not), greedy generate with its per-step logits, and its
    cache after the padded prefill and after each generated token is
    decoded."""
    jscfg = JStep(dora=jcfg)
    state = {}
    for fold in (True, False):
        tree = flatten_paths(_np_tree(jmake_precompute_step(
            jm, jscfg, None, fold_gsb=fold)(jp, ja)))
        state[fold] = {k: v for k, v in tree.items()
                       if k.rsplit("/", 1)[1] in ("g", "gsB")}
    prompts = tokens[:, :PROMPT]
    toks, logits = jgenerate(jm, jp, ja, jscfg, jnp.asarray(prompts),
                             gen_len=GEN, max_len=MAX_LEN,
                             return_logits=True)
    toks = np.asarray(toks)
    st = jmake_precompute_step(jm, jscfg, None)(jp, ja)
    padded = np.pad(prompts, ((0, 0), (0, MAX_LEN - PROMPT)))
    _, cache = jmake_prefill_step(jm, jscfg, None, batch=BATCH, seq=MAX_LEN,
                                  padded=True)(
        jp, st, {"tokens": jnp.asarray(padded),
                 "prompt_len": jnp.asarray(PROMPT, jnp.int32)})

    def kv(c):
        return {f"{li}/{n}": np.asarray(t)
                for li, layer in c["stack"].items() for n, t in layer.items()}

    kv_prefill = kv(cache)
    decode = jmake_decode_step(jm, jscfg, None, batch=BATCH)
    for t in range(GEN):
        _, cache = decode(jp, st, cache, {"tokens": jnp.asarray(
            toks[:, PROMPT + t:PROMPT + t + 1])})
    return {"state": state, "tokens": toks,
            "logits": [np.asarray(x) for x in logits],
            "kv_prefill": kv_prefill, "kv_last": kv(cache)}


def _cases(world, inputs):
    """Every case of one world size, with copies of the inputs."""
    params, adapters, tokens, labels = inputs["state"]
    model = {"widths": WIDTHS, "params": _np_tree(params),
             "adapters": _np_tree(adapters)}
    shape, axes = NORM[world]
    cases = [("norm", "norm_case", {**{k: np.array(v) for k, v in
                                       inputs["norm"].items()},
                                    "shape": shape, "axes": axes})]
    for name, (d, t, spec) in COMPOSE[world].items():
        cases.append((f"compose_{name}", "compose_case",
                      {**{k: np.array(v) for k, v in
                          inputs["compose"].items()},
                       "shape": (d, t), "spec": spec}))
    for mshape, route in TRAIN[world]:
        cases.append((f"train_{mshape}_{route}", "train_case",
                      {**model, "shape": mshape, "optim": OPTIM,
                       "loss_tokens": LOSS_TOKENS,
                       "dora": dict(rank=RANK, alpha=ALPHA, **ROUTES[route]),
                       "tokens": tokens.copy(), "labels": labels.copy()}))
    cases.append(("prefill", "prefill_case",
                  {**model, "shape": PREFILL[world], "batch": BATCH,
                   "seq": SEQ, "dora": dict(rank=RANK, alpha=ALPHA,
                                            **ROUTES["mm"]),
                   "tokens": tokens.copy()}))
    for mshape, route in SERVE[world]:
        mt = {} if route != "mm" else {
            "tenants": _np_tree(inputs["tenants"]),
            "mt_prompts": _mt_prompts(), "mt_owners": MT_OWNERS,
            "prompt_len": PROMPT}
        cases.append((f"serve_{mshape}_{route}", "serve_case",
                      {**model, "shape": mshape,
                       "dora": dict(rank=RANK, alpha=ALPHA, **ROUTES[route]),
                       "prompts": tokens[:, :PROMPT].copy(),
                       "gen_len": GEN, "max_len": MAX_LEN,
                       "temperature": TEMPERATURE, "seed": SAMPLE_SEED,
                       **mt}))
    if world == 4:
        cases.append(("compression", "compression_case",
                      {k: np.array(v) for k, v in
                       inputs["compression"].items()}))
    cases.append(("placements", "placements_case", {}))
    cases.append(("roundtrip", "roundtrip_case",
                  {**model, "shape": PREFILL[world],
                   "dora": dict(rank=RANK, alpha=ALPHA)}))
    return cases


@pytest.fixture(scope="module")
def ranks(spawned, reference):
    """{world: rank 0's results}, joined after the reference ran."""
    return {w: h.join() for w, h in spawned.items()}


# --- the tests -------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_factored_norm_sharded_matches_reference(world, ranks, reference,
                                                  inputs):
    """Every variant within 1e-5 of max of the reference's unsharded norm
    and of its fp64 oracle; the sums' bytes: base_sq and cross [d_out]
    and G [r, r] in fp32 (base_sq's left out with the cache, one sum at
    s = 0 without it, none with it)."""
    d_out = inputs["norm"]["W"].shape[0]
    for (kernels, s_nz, cached), (w, stats) in ranks[world]["norm"].items():
        key = (s_nz, cached)
        assert _max_rel(w, reference["norm"][key]) <= 1e-5, (kernels, key)
        if not cached:
            assert _max_rel(w, reference["fp64"][s_nz]) <= 1e-5
        want = ((0 if cached else d_out * 4) + d_out * 4 + RANK * RANK * 4
                if s_nz else (0 if cached else d_out * 4))
        assert stats["bytes"] == want, (kernels, key, stats)


@pytest.mark.parametrize("world,layout", [(w, name) for w in COMPOSE
                                          for name in COMPOSE[w]])
def test_shard_local_compose_matches_reference_vjp(world, layout, ranks,
                                                   reference):
    got = ranks[world][f"compose_{layout}"]
    for k, want in reference["compose"].items():
        assert _max_rel(got[k], want) <= 1e-5, (layout, k)
    assert got["fwd_collectives"] == 0
    tags = set(got["collectives"])
    spec = COMPOSE[world][layout][2]
    assert ("compose.d_h" in tags) == (spec[-1] is not None)
    assert ("compose.T" in tags) == (spec[0] is not None)


def _train_cases():
    return [(w, s, r) for w, cases in TRAIN.items() for s, r in cases]


@pytest.mark.parametrize("world,shape,route", _train_cases(), ids=str)
def test_mesh_train_step_matches_reference(world, shape, route, ranks,
                                           reference):
    """Loss within 1e-5 relative of the reference's, the gathered adapter
    gradients within 1e-4 of max, one AdamW step's loss and grad norm
    (its clip's norm summed across shards) within 1e-5; the norm's sums
    move base_sq, cross and G of each row-parallel module at model > 1."""
    got = ranks[world][f"train_{shape}_{route}"]
    assert abs(got["loss"] / reference["loss"] - 1) <= 1e-5
    assert abs(got["step_loss"] / reference["step"]["loss"] - 1) <= 1e-5
    assert abs(got["grad_norm"] / reference["step"]["grad_norm"] - 1) \
        <= 1e-5
    assert set(got["grads"]) == set(reference["grads"])
    for name, want in reference["grads"].items():
        assert _max_rel(got["grads"][name], want) <= 1e-4, name
    # Each of the 7 modules a layer: its norm (K1; with the epilogue, or
    # the standalone K2 on wo and w_down), and the compose forward twice
    # (the layer and its recompute) and backward once.
    per = 7 * WIDTHS["num_layers"]
    compose = {"mm": {"compose_mm_fwd_plain": 2 * per,
                      "compose_mm_bwd_plain": per},
               "elementwise": {"compose_fwd_dual_plain": 2 * per,
                               "compose_bwd_plain": per}}.get(route)
    assert got["plain_calls"] == ({} if compose is None else {
        "norm_terms_plain": per, "assemble_norm_plain": per, **compose})
    norm = got["collectives"].get("norm", {"bytes": 0})["bytes"]
    d = WIDTHS["d_model"]
    per_module = 2 * d * 4 + RANK * RANK * 4
    assert norm == (2 * WIDTHS["num_layers"] * per_module if shape[1] > 1
                    else 0)


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_prefill_matches_reference(world, ranks, reference):
    got = ranks[world]["prefill"]
    last, k0 = reference["prefill"]
    assert _max_rel(got["logits"], last) <= 1e-5
    assert got["len"] == SEQ
    d, t = PREFILL[world]
    coords = got["coords"]
    kv = WIDTHS["num_kv_heads"] // t
    rows = BATCH // d
    want = k0[:, coords["data"] * rows:(coords["data"] + 1) * rows, :,
              coords["model"] * kv:(coords["model"] + 1) * kv]
    assert _max_rel(got["k0"], want) <= 1e-5


def test_cross_pod_sync_matches_reference_compression(ranks):
    """On a (pod=2, data=2) mesh: each pod's fp32 data mean quantized by
    the reference's int8_ef_compress, dequantized and averaged over the
    pods gives the port's synced gradient (1e-6 of max), which is within
    the example's 2 % of the fp32 mean over all ranks; the pod axis moves
    one int8 byte an element a pod; the residual carries to the next
    step."""
    got = ranks[4]["compression"]
    c = _compression_inputs()
    quarter = c["x"].reshape(4, 4, -1).mean(axis=1) * (c["w"] - c["t"])
    pods = quarter.reshape(2, 2, -1).mean(axis=1)          # fp32 over data
    ef = jcomp.init_error_feedback({"g": jnp.zeros(pods.shape[1])})
    deqs, new_efs = [], []
    for p in pods:
        q, scale, corr = jcomp.int8_ef_compress({"g": jnp.asarray(p)}, ef)
        deq, new_ef = jcomp.int8_ef_decompress(q, scale, corr)
        deqs.append(np.asarray(deq["g"]))
        new_efs.append(np.asarray(new_ef["g"]))
    assert _max_rel(got["synced"], np.mean(deqs, axis=0)) <= 1e-6
    exact = quarter.mean(axis=0)
    rel = np.linalg.norm(got["synced"] - exact) / np.linalg.norm(exact)
    assert rel < 0.02, rel
    d = exact.shape[0]
    assert got["stats"]["grad.pod"]["bytes"] == 2 * d
    assert got["stats"]["grad.data"]["bytes"] == 4 * d
    assert any(_max_rel(got["ef"], e) <= 1e-6 for e in new_efs)
    assert np.linalg.norm(got["ef2"]) > 0 and np.isfinite(got["again"]).all()


@pytest.mark.parametrize("world", [2, 4])
def test_shard_then_unshard_is_the_tree(world, ranks):
    assert ranks[world]["roundtrip"] is True


@pytest.mark.parametrize("world", [2, 4])
def test_nccl_mesh_gathers_placements_and_refuses_a_shared_card(world,
                                                                 ranks):
    """make_mesh's NCCL check on real ranks: each rank's (host, card) is
    gathered in rank order; ranks that all name card 0 are refused,
    naming the first two and backend='gloo'; one card a rank passes."""
    got = ranks[world]["placements"]
    hosts = {h for h, _ in got["shared"]}
    assert len(hosts) == 1 and len(got["shared"]) == world
    assert [c for _, c in got["shared"]] == [0] * world
    assert [c for _, c in got["own"]] == list(range(world))
    assert "ranks 0 and 1 would share card 0" in got["refused"]
    assert "backend='gloo'" in got["refused"]


def _serve_cases():
    return [(w, s, r) for w, cases in SERVE.items() for s, r in cases]


@pytest.mark.parametrize("world,shape,route", _serve_cases(), ids=str)
def test_mesh_precompute_matches_reference(world, shape, route, ranks,
                                           reference):
    """(a) Every g and gsB leaf of make_precompute_step(mesh=), folded
    and not, gathered over its serving spec, within 1e-5 of max of the
    reference's unsharded make_precompute_step."""
    got = ranks[world][f"serve_{shape}_{route}"]["state"]
    for fold, want in reference["serve"]["state"].items():
        assert set(got[fold]) == set(want), fold
        for name, w in want.items():
            assert _max_rel(got[fold][name], w) <= 1e-5, (fold, name)


@pytest.mark.parametrize("world,shape,route", _serve_cases(), ids=str)
def test_mesh_generate_matches_reference(world, shape, route, ranks,
                                         reference):
    """(b) generate(mesh=): the prefill's and every decode step's logits
    within 1e-5 of max |logit| of the reference's; each step's least
    top-2 gap at least GAP_MIN, then the tokens equal and the same on
    every rank; the gathered K/V after the prefill and after the last
    decode step within 1e-5 of the reference's cache. On the kernel
    route, the wrappers' plain versions ran as the serving path launches
    its kernels: K1 (with its epilogue on the column-parallel modules,
    its terms and the standalone K2 on wo and w_down) once per module in
    the precompute, K6 per module in the prefill and each decode step."""
    got = ranks[world][f"serve_{shape}_{route}"]
    ref = reference["serve"]
    assert len(got["logits"]) == len(ref["logits"]) == GEN
    for step, (g, w) in enumerate(zip(got["logits"], ref["logits"])):
        assert _max_rel(g, w) <= 1e-5, step
        top2 = np.sort(w, axis=-1)[:, -2:]
        gap = (top2[:, 1] - top2[:, 0]).min() / np.abs(w).max()
        assert gap >= GAP_MIN, (step, gap)
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    assert got["same_on_every_rank"]
    for when in ("kv_prefill", "kv_last"):
        assert set(got[when]) == set(ref[when])
        for name, w in ref[when].items():
            assert _max_rel(got[when][name], w) <= 1e-5, (when, name)
    assert got["len"] == PROMPT + GEN
    per = 7 * WIDTHS["num_layers"]
    assert got["plain_calls"] == ({} if route == "eager" else {
        "norm_terms_plain": per, "assemble_norm_plain": per,
        "compose_mm_fwd_plain": (1 + GEN) * per})


@pytest.mark.parametrize("world,shape,route", _serve_cases(), ids=str)
def test_mesh_generate_samples_as_one_card(world, shape, route, ranks):
    """(c) With temperature > 0 every rank samples the whole batch with
    the same generator: the tokens are the port's single-card
    generate's for the same seed."""
    got = ranks[world][f"serve_{shape}_{route}"]
    assert got["sampled"].shape == (BATCH, PROMPT + GEN)
    np.testing.assert_array_equal(got["sampled"], got["sampled_single"])
    assert not np.array_equal(got["sampled"], got["tokens"])


@pytest.mark.parametrize("world,shape,route", _serve_cases(), ids=str)
def test_mesh_generate_through_for_serving(world, shape, route, ranks,
                                           reference):
    """(d) A handle through AdapterStateCache.for_serving(mesh=), keyed
    on the mesh's fingerprint, serves the reference's tokens; a cache
    keyed for another mesh is refused."""
    got = ranks[world][f"serve_{shape}_{route}"]
    np.testing.assert_array_equal(got["handle_tokens"],
                                  reference["serve"]["tokens"])
    assert got["cache_key"] == (("data", shape[0]), ("model", shape[1]))
    assert "keyed for sharding" in got["other_mesh_refused"]


@pytest.mark.parametrize("shape", [dict(data=2, model=2),
                                   dict(model=4, data=1),
                                   dict(pod=2, data=4, model=16)], ids=str)
def test_mesh_fingerprint_matches_reference(shape):
    """(e) The port's mesh_fingerprint is the reference's on a duck
    mesh: the axes in mesh order with their sizes; None for no mesh."""
    mesh = R._DuckMesh(**shape)
    assert mesh_fingerprint(mesh) == jmesh_fingerprint(mesh)
    assert mesh_fingerprint(mesh) == tuple(shape.items())
    assert mesh_fingerprint(None) is jmesh_fingerprint(None) is None


# --- the continuous-batching engine across the mesh --------------------------

def _engine_traces(world):
    """{name: (trace, prompts, engine kwargs, submit kwargs)} of one
    world size: the committed traces, and on (2, 2) the priority and
    deadline trace."""
    out = {}
    for section in ("continuous", "paged"):
        trace, kw, _ = _bench(section)
        out[section] = (trace, _prompts(trace), kw, {})
    if world == 4:
        out["priority"] = (PRIORITY_TRACE, _prompts(PRIORITY_TRACE, seed=4),
                           {"slots": 2, "max_len": 16}, PRIORITY_SUBMIT)
    return out


def _server_prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, WIDTHS["vocab_size"], n, dtype=np.int32)
            for n in SERVER_LENS]


def _mt_engine_traces():
    """{name: (trace, prompts, engine kwargs, owners)}: the committed
    traces with the requests spread over the three handles."""
    out = {}
    for section in ("continuous", "paged"):
        trace, kw, _ = _bench(section)
        owners = [f"t{i % MT_TENANTS}" for i in range(len(trace))]
        out[section] = (trace, _prompts(trace, seed=13), kw, owners)
    return out


def _mt_server_owners():
    return [f"t{(i + 1) % MT_TENANTS}" for i in range(len(SERVER_LENS))]


def _fleet_traces():
    """{name: (trace, prompts, engine kwargs)}: the committed fleet trace
    ((arrival, P, new tokens, tenant) per request) at its 3 slots, and at
    4 slots, whose rows split over the data axis."""
    from test_torch_fleet import fleet_trace

    trace, kw, _ = fleet_trace()
    prompts = _prompts(trace, seed=14)
    return {"fleet": (trace, prompts, kw),
            "fleet4": (trace, prompts, {**kw, "slots": 4})}


def _spec_inputs(params, adapters):
    """The committed speculative trace and the identity adapters: B = 0
    and m each row's norm of W as the port computes it on one card, so
    one card's g is 1 exactly (numpy)."""
    from test_torch_speculative import _spec_trace

    from repro_torch.bridge import tree_from_numpy, tree_to_numpy
    from repro_torch.core.adapter import compute_weight_norm
    from repro_torch.core.config import DoRAConfig

    trace, slots, max_len, k, model = _spec_trace()
    params = tree_from_numpy(_np_tree(params))
    ident = tree_from_numpy(_np_tree(adapters))
    fp, fa = flatten_paths(params), flatten_paths(ident)
    dcfg = DoRAConfig(rank=RANK, alpha=ALPHA, **ROUTES["mm"])
    for name, leaf in fa.items():
        if name.endswith("/B"):
            leaf.zero_()
    for name, m in fa.items():
        if name.endswith("/m"):
            pre = name[:-2]
            for i in range(m.shape[0]):
                m[i] = compute_weight_norm(fp[pre][i], fa[pre + "/A"][i],
                                           fa[pre + "/B"][i], dcfg)
    return {"trace": trace, "prompts": _prompts(trace, seed=15), "k": k,
            "kw": {"slots": slots, "max_len": max_len},
            "identity": tree_to_numpy(ident), "model": model}


def _spec_payload(spec):
    """The ranks' copy of ``_spec_inputs``."""
    return {"trace": [tuple(r) for r in spec["trace"]],
            "prompts": [q.copy() for q in spec["prompts"]], "k": spec["k"],
            "kw": dict(spec["kw"]), "identity": _np_tree(spec["identity"]),
            "paged": dict(PAGED_GEO)}


def _engine_cases(world, inputs):
    params, adapters, _, _ = inputs["state"]
    model = {"widths": WIDTHS, "params": _np_tree(params),
             "adapters": _np_tree(adapters)}
    traces = {k: (list(t), [q.copy() for q in pr], dict(kw), dict(sub))
              for k, (t, pr, kw, sub) in _engine_traces(world).items()}
    mt = {k: (list(t), [q.copy() for q in pr], dict(kw), list(own))
          for k, (t, pr, kw, own) in _mt_engine_traces().items()}
    return [(f"engine_{shape}", "engine_case",
             {**model, "shape": shape,
              "dora": dict(rank=RANK, alpha=ALPHA, **ROUTES["mm"]),
              "traces": traces,
              "server": ([q.copy() for q in _server_prompts()],
                         dict(SERVER_KW), SERVER_GEN),
              "tenants": _np_tree(inputs["tenants"]), "mt_traces": mt,
              "mt_server": ([q.copy() for q in _server_prompts()],
                            _mt_server_owners(), dict(SERVER_KW),
                            SERVER_GEN),
              "fleet": {"tenants": _np_tree(inputs["fleet_tenants"]),
                        "traces": {k: ([list(r) for r in t],
                                       [q.copy() for q in pr], dict(kw))
                                   for k, (t, pr, kw)
                                   in _fleet_traces().items()},
                        "paged": dict(PAGED_GEO)},
              "spec": _spec_payload(inputs["spec"])})
            for shape in ENGINE[world]]


@pytest.fixture(scope="module")
def engine_spawned(inputs, tmp_path_factory):
    """The engine's ranks of both world sizes, started before the
    reference's engines run."""
    handles = {w: R.Ranks(w, _engine_cases(w, inputs),
                          tmp_path_factory.mktemp(f"engine{w}"),
                          timeout=ENGINE_TIMEOUT_S)
               for w in ENGINE}
    yield handles
    for h in handles.values():
        h.kill()


@pytest.fixture(scope="module")
def engine_reference(inputs, engine_spawned):
    """The reference's single-device DecodeEngine on each trace (its
    precompute's folded serving tree) and its EngineServer, computed while
    the ranks run."""
    params, adapters, _, _ = inputs["state"]
    jm = JModel(**WIDTHS, dtype=jnp.float32)
    jscfg = JStep(dora=JConfig(rank=RANK, alpha=ALPHA, mode="eager"))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ja = jax.tree_util.tree_map(jnp.asarray, adapters)
    serving = jax.jit(jmake_precompute_step(jm, jscfg, None, fold_gsb=True))(
        jp, ja)
    out = {}
    for name, (trace, prompts, kw, submit) in _engine_traces(4).items():
        eng = JEngine(jm, jscfg, jp, adapters=serving, **kw)
        streams = _drive(eng, trace, prompts, **submit)
        out[name] = {"streams": streams, "stats": eng.stats().as_dict(),
                     "results": [(r.request_id, np.asarray(r.tokens).tolist(),
                                  r.finish_reason, r.admitted_step,
                                  r.finished_step, r.preempted)
                                 for r in eng.pop_results()],
                     "pool": eng.pool_stats() if kw.get("paged") else None}
    cache = jcore.AdapterStateCache.for_serving(jm, jscfg)
    cache.register("t0", adapters)
    server = JServer(jm, jscfg, jp, cache=cache, **SERVER_KW)
    res = server.run([JRequest(q, "t0") for q in _server_prompts()],
                     gen_len=SERVER_GEN)
    out["server"] = {"tokens": [np.asarray(r.tokens).tolist() for r in res],
                     "reasons": [r.finish_reason for r in res],
                     "stats": server.engine.stats().as_dict(),
                     "pool": server.engine.pool_stats()}
    out.update(_reference_engine_tenants(jm, jscfg, jp, inputs["tenants"]))
    out.update(_reference_fleet(jm, jscfg, jp, inputs))
    out.update(_reference_speculative(jm, jscfg, jp, inputs))
    return out


def _reference_fleet(jm, jscfg, jp, inputs):
    """The reference's single-device dynamic engine on _fleet_traces(),
    rectangular and paged (streams, stats, the cache's stats), the port's
    single-card dynamic engine on the same (device steps, sampled rows'
    logits), and the reference's MultiTenantServer(dynamic_grouping=True)
    on the mixed lengths, plain and with speculative_k=3."""
    import torch
    from test_torch_fleet import capture_logits

    from repro_torch.bridge import tree_from_numpy
    from repro_torch.core.adapter_cache import AdapterStateCache
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models.config import ModelConfig

    tenants = inputs["fleet_tenants"]
    tm = ModelConfig(**WIDTHS, dtype=torch.float32)
    tscfg = StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA,
                                       **ROUTES["mm"]))
    tparams = tree_from_numpy(inputs["state"][0])
    out = {}
    for name, (trace, prompts, kw) in _fleet_traces().items():
        owners = [f"t{r[3]}" for r in trace]
        for form, geo in (("dynamic", {}), ("dynamic_paged", PAGED_GEO)):
            cache = _tenant_jcache(jm, jscfg, tenants)
            eng = JEngine(jm, jscfg, jp, adapter_cache=cache,
                          dynamic_grouping=True, **kw, **geo)
            streams = _drive(eng, [r[:3] for r in trace], prompts,
                             adapter=owners)
            tcache = AdapterStateCache.for_serving(tm, tscfg, device="cpu")
            for t, ad in enumerate(tenants):
                tcache.register(f"t{t}", tree_from_numpy(ad))
            one = DecodeEngine(tm, tscfg, tparams, adapter_cache=tcache,
                               dynamic_grouping=True, device="cpu", **kw,
                               **geo)
            logits = capture_logits(one)
            one_streams = _drive(one, [r[:3] for r in trace], prompts,
                                 adapter=owners)
            out[f"{name}_{form}"] = {
                "streams": streams, "stats": eng.stats().as_dict(),
                "cache": cache.stats(), "one_streams": one_streams,
                "one_steps": one.device_steps(), "one_logits": logits}
    cache = _tenant_jcache(jm, jscfg, inputs["tenants"])
    server = JMTServer(jm, jscfg, jp, cache=cache, dynamic_grouping=True,
                       engine_slots=SERVER_KW["slots"])
    reqs = [JRequest(q, t) for q, t in zip(_server_prompts(),
                                            _mt_server_owners())]
    out["mt_dynamic_server"] = {
        "plain": [np.asarray(t).tolist() for t in server.serve(
            reqs, gen_len=SERVER_GEN, max_len=SERVER_KW["max_len"])],
        "speculative": [np.asarray(t).tolist() for t in server.serve(
            reqs, gen_len=SERVER_GEN, max_len=SERVER_KW["max_len"],
            speculative_k=3)],
        "cache": cache.stats()}
    return out


def _reference_speculative(jm, jscfg, jp, inputs):
    """The reference's single-device engine with identity adapters (its
    state's g = 1 and gsB = 0 written in, as tests/test_torch_speculative
    does) at k = 3 on the committed speculative trace, rectangular and
    paged, and its EngineServer.run(speculative_k=3) of the mixed
    lengths over the three tenants."""
    spec = inputs["spec"]
    ident = jax.tree_util.tree_map(jnp.asarray, spec["identity"])
    state = _np_tree(jax.jit(jmake_precompute_step(
        jm, jscfg, None, fold_gsb=True))(jp, ident))
    for name, leaf in flatten_paths(state).items():
        if name.endswith("/g"):
            leaf[...] = 1.0
        elif name.endswith("/gsB"):
            leaf[...] = 0.0
    out = {}
    for geo_name, geo in (("rect", {}), ("paged", PAGED_GEO)):
        eng = JEngine(jm, jscfg, jp, adapters=state,
                      speculative_k=spec["k"], **spec["kw"], **geo)
        streams = _drive(eng, spec["trace"], spec["prompts"])
        out[f"spec_identity_{geo_name}"] = {
            "streams": streams, "stats": eng.stats().as_dict()}
    cache = _tenant_jcache(jm, jscfg, inputs["tenants"])
    server = JServer(jm, jscfg, jp, cache=cache, **SERVER_KW)
    res = server.run([JRequest(q, t) for q, t in
                      zip(_server_prompts(), _mt_server_owners())],
                     gen_len=SERVER_GEN, speculative_k=3)
    out["spec_server"] = {
        "tokens": [np.asarray(r.tokens).tolist() for r in res],
        "reasons": [r.finish_reason for r in res],
        "stats": server.engine.stats().as_dict(), "cache": cache.stats()}
    return out


def _tenant_jcache(jm, jscfg, tenants):
    cache = jcore.AdapterStateCache.for_serving(jm, jscfg)
    for t, ad in enumerate(tenants):
        cache.register(f"t{t}", _np_tree(ad))
    return cache


def _reference_engine_tenants(jm, jscfg, jp, tenants):
    """The reference's single-device cache-routed DecodeEngine on
    _mt_engine_traces() and its EngineServer on the mixed lengths, the
    requests spread over the three handles."""
    out = {}
    for name, (trace, prompts, kw, owners) in _mt_engine_traces().items():
        cache = _tenant_jcache(jm, jscfg, tenants)
        eng = JEngine(jm, jscfg, jp, adapter_cache=cache, **kw)
        streams = _drive(eng, trace, prompts, adapter=owners)
        out[f"mt_{name}"] = {
            "streams": streams, "stats": eng.stats().as_dict(),
            "results": [(r.request_id, np.asarray(r.tokens).tolist(),
                         r.finish_reason) for r in eng.pop_results()],
            "cache": cache.stats()}
    cache = _tenant_jcache(jm, jscfg, tenants)
    server = JServer(jm, jscfg, jp, cache=cache, **SERVER_KW)
    res = server.run([JRequest(q, t) for q, t in
                      zip(_server_prompts(), _mt_server_owners())],
                     gen_len=SERVER_GEN)
    out["mt_server"] = {
        "tokens": [np.asarray(r.tokens).tolist() for r in res],
        "reasons": [r.finish_reason for r in res],
        "stats": server.engine.stats().as_dict(), "cache": cache.stats()}
    return out


@pytest.fixture(scope="module")
def engine_ranks(engine_spawned, engine_reference):
    return {w: h.join() for w, h in engine_spawned.items()}


def _engine_runs():
    return [(w, s, name, route) for w, shapes in ENGINE.items()
            for s in shapes
            for name in (("continuous", "paged", "priority") if w == 4
                         else ("continuous", "paged"))
            for route in ("fixed", "cache")]


@pytest.mark.parametrize("world,shape,trace,route", _engine_runs(), ids=str)
def test_mesh_engine_matches_reference(world, shape, trace, route,
                                       engine_ranks, engine_reference):
    """DecodeEngine(mesh=) on a trace, by a fixed serving tree of the mesh
    precompute or a one-handle cache of for_serving(mesh=): the streams,
    the results, stats() and pool_stats() equal the reference's
    single-device engine; the committed traces' counters equal
    BENCH_serve.json's schedule models (41 / 35 / 12 / 88 / 76; paged
    41 / 35 / 13 / 94 / 81, a peak of 13 blocks, 18 chunk prefills); K8's
    plain version ran 2 x layers x (decode + chunk steps) times on this
    rank (none on the rectangular cache); every rank returned the same."""
    got = engine_ranks[world][f"engine_{shape}"][f"{trace}_{route}"]
    want = engine_reference[trace]
    assert got["streams"] == want["streams"]
    assert got["results"] == want["results"]
    assert got["stats"] == want["stats"]
    assert got["pool"] == want["pool"]
    steps = got["device_steps"]
    assert got["gathers"] == 2 * WIDTHS["num_layers"] * (
        steps["decode"] + steps["prefill_chunk"]) * (trace == "paged")
    assert got["same_on_every_rank"]
    if trace == "priority":
        assert got["stats"]["preemptions"] >= 1
        assert got["stats"]["timeouts"] == 2
        return
    model = _bench(trace)[2]
    for field in ("steps", "decode_steps", "prefills", "generated_tokens",
                  "slot_steps", "mean_occupancy"):
        assert got["stats"][field] == model[field], field
    if trace == "paged":
        assert got["pool"]["peak_used_blocks"] == model["peak_used_blocks"]
        assert got["pool"]["used_blocks"] == 0
        assert steps["prefill_chunk"] == 18


@pytest.mark.parametrize("world,shape", [(w, s) for w, shapes in
                                         ENGINE.items() for s in shapes],
                         ids=str)
def test_mesh_engine_server_matches_reference(world, shape, engine_ranks,
                                              engine_reference):
    """EngineServer(mesh=).run of mixed prompt lengths through the paged
    engine: tokens, finish reasons, stats() and pool_stats() equal the
    reference's EngineServer; every rank returned the same."""
    got = engine_ranks[world][f"engine_{shape}"]["server"]
    want = engine_reference["server"]
    assert got["same_on_every_rank"]
    assert got["reasons"] == want["reasons"] == ["length"] * len(SERVER_LENS)
    assert got["tokens"] == want["tokens"]
    assert got["stats"] == want["stats"]
    assert got["pool"] == want["pool"]


# --- static tenant groups across the mesh ------------------------------------

def _mt_cases():
    return [(w, s) for w, cases in SERVE.items() for s, r in cases
            if r == "mm"]


def _same_cache_counts(got: dict, want) -> None:
    for field in ("hits", "misses", "evictions", "entries"):
        assert got[field] == getattr(want, field), field


@pytest.mark.parametrize("world,shape", _mt_cases(), ids=str)
def test_mesh_multitenant_server_matches_reference(world, shape, ranks,
                                                   reference):
    """MultiTenantServer(mesh=) with three tenants (batch 6 grouped
    ((0, 2), (2, 2), (4, 2)); at data 2 tenant 1's group straddles the
    replicas): every step's logits within 1e-5 of max |logit| of the
    reference's single-device server, each step's least top-2 gap at
    least GAP_MIN, then the tokens equal; the warm call the same tokens;
    the cache three misses then three hits, its stats and the tokens the
    same on every rank; a max_len that model = 2 does not split refused;
    the three tenants' first tokens' logits on one shared prompt differ
    pairwise."""
    got = ranks[world][f"serve_{shape}_mm"]["mt"]
    ref = reference["mt"]
    assert got["groups"] == MT_GROUPS
    assert len(got["logits"]) == len(ref["logits"]) == GEN
    for step, (g, w) in enumerate(zip(got["logits"], ref["logits"])):
        assert _max_rel(g, w) <= 1e-5, step
        top2 = np.sort(w, axis=-1)[:, -2:]
        gap = (top2[:, 1] - top2[:, 0]).min() / np.abs(w).max()
        assert gap >= GAP_MIN, (step, gap)
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    np.testing.assert_array_equal(got["warm_tokens"], got["tokens"])
    assert got["cache"]["misses"] == MT_TENANTS
    assert got["cache"]["hits"] == MT_TENANTS
    assert got["same_on_every_rank"]
    refused = got["odd_max_len_refused"]
    assert (refused is not None) == (shape[1] > 1)
    if refused is not None:
        assert "does not split" in refused and "model=2" in refused
    first = got["logits"][0]
    for a in range(MT_TENANTS):
        for b in range(a + 1, MT_TENANTS):
            assert _max_rel(first[a], first[b]) > 1e-3, (a, b)


@pytest.mark.parametrize("world,shape", _mt_cases(), ids=str)
def test_mesh_grouped_delta_is_bitwise_and_costs_no_collective(
        world, shape, ranks):
    """Layer 0's wq (column-parallel) and wo (row-parallel), grouped on
    this rank's shards under the decode and the sequence-parallel
    layouts: each local group of two or more rows has the homogeneous
    mesh path's delta on the same rows (its h, on the same y_base rows)
    bit for bit, and every group's output is within 1e-6 of max of the
    homogeneous module on its rows alone. A grouped decode step makes the
    collective calls and moves the bytes of a single-tenant one at the
    same batch, tag by tag."""
    got = ranks[world][f"serve_{shape}_mm"]["mt"]
    assert got["delta_bitwise"] and all(got["delta_bitwise"])
    assert max(got["module_rel"]) <= 1e-6
    coll = got["decode_collectives"]
    assert coll["grouped"] == coll["single"]
    assert bool(coll["grouped"]) == (shape[1] > 1)


def _mt_engine_runs():
    return [(w, s, name) for w, shapes in ENGINE.items() for s in shapes
            for name in ("continuous", "paged")]


@pytest.mark.parametrize("world,shape,trace", _mt_engine_runs(), ids=str)
def test_mesh_engine_with_several_handles_matches_reference(
        world, shape, trace, engine_ranks, engine_reference):
    """The cache-routed DecodeEngine(mesh=) with the trace's requests
    spread over three handles (slot layouts of two or more handles, a
    run of them possibly spanning the data replicas): streams, results
    and stats() equal the reference's single-device engine, and the
    cache's counts; decode steps ran under grouped signatures; K8's plain
    version ran 2 x layers x (decode + chunk steps) on the paged engine;
    every rank returned the same, its cache stats included."""
    got = engine_ranks[world][f"engine_{shape}"][f"mt_{trace}"]
    want = engine_reference[f"mt_{trace}"]
    assert got["streams"] == want["streams"]
    assert got["results"] == want["results"]
    assert got["stats"] == want["stats"]
    _same_cache_counts(got["cache"], want["cache"])
    assert any(k not in ("None", "dynamic")
               for k in got["signatures"]["decode"])
    steps = got["device_steps"]
    assert got["gathers"] == 2 * WIDTHS["num_layers"] * (
        steps["decode"] + steps["prefill_chunk"]) * (trace == "paged")
    assert got["same_on_every_rank"]


@pytest.mark.parametrize("world,shape", [(w, s) for w, shapes in
                                         ENGINE.items() for s in shapes],
                         ids=str)
def test_mesh_engine_server_with_several_handles_matches_reference(
        world, shape, engine_ranks, engine_reference):
    """EngineServer(mesh=).run of mixed prompt lengths under three
    handles through the paged engine: tokens, finish reasons, stats() and
    the cache's counts equal the reference's EngineServer; every rank
    returned the same."""
    got = engine_ranks[world][f"engine_{shape}"]["mt_server"]
    want = engine_reference["mt_server"]
    assert got["same_on_every_rank"]
    assert got["reasons"] == want["reasons"] == ["length"] * len(SERVER_LENS)
    assert got["tokens"] == want["tokens"]
    assert got["stats"] == want["stats"]
    _same_cache_counts(got["cache"], want["cache"])
    assert any(k not in ("None", "dynamic")
               for k in got["signatures"]["decode"])


# --- dynamic grouping and speculation across the mesh ------------------------

def _max_rel_rows(got: dict, want: dict) -> float:
    """Largest distance over max |logit| between two engines' sampled
    rows, keyed (key_id, tokens sampled before)."""
    assert got.keys() == want.keys()
    return max(_max_rel(got[k], want[k]) for k in want)


def _fleet_runs():
    return [(w, s, name, form) for w, shapes in ENGINE.items()
            for s in shapes for name in ("fleet", "fleet4")
            for form in ("dynamic", "dynamic_paged")]


@pytest.mark.parametrize("world,shape,trace,form", _fleet_runs(), ids=str)
def test_mesh_dynamic_engine_matches_reference(world, shape, trace, form,
                                               engine_ranks,
                                               engine_reference):
    """DecodeEngine(mesh=, dynamic_grouping=True) over five tenants on the
    committed fleet trace, at its 3 slots (every replica holds the whole
    batch) and at 4 (the rows split over data), rectangular and paged:
    streams, stats() and the cache's counts equal the reference's
    single-device dynamic engine; device steps and streams those of the
    port's single-card dynamic engine, and every sampled row's logits
    within 1e-5 of max |logit| of it; every decode under the one
    signature "dynamic"; K8's plain version 2 x layers x (decode + chunk
    steps) on the paged engine; every rank returned the same, its cache
    stats included. At 3 slots, rectangular, the counters equal
    fleet.schedule_model (one dynamic signature), and at both widths the
    static engine on the same mesh gives the same streams with logits
    within FLEET_INSIDE of the dynamic ones."""
    ranks = engine_ranks[world][f"engine_{shape}"]
    got, want = ranks[f"{trace}_{form}"], engine_reference[f"{trace}_{form}"]
    assert got["same_on_every_rank"]
    assert got["streams"] == want["streams"] == want["one_streams"]
    assert got["stats"] == want["stats"]
    _same_cache_counts(got["cache"], want["cache"])
    steps = got["device_steps"]
    assert steps == want["one_steps"]
    assert got["signatures"]["decode"] == {"dynamic": steps["decode"]}
    assert _max_rel_rows(got["logits"], want["one_logits"]) <= 1e-5
    assert got["gathers"] == 2 * WIDTHS["num_layers"] * (
        steps["decode"] + steps["prefill_chunk"]) * (form != "dynamic")
    if form != "dynamic":
        assert got["pool"]["used_blocks"] == 0
        return
    static = ranks[f"{trace}_static"]
    assert static["same_on_every_rank"]
    assert static["streams"] == got["streams"]
    assert got["vs_static"] <= FLEET_INSIDE
    if trace == "fleet":
        from test_torch_fleet import fleet_trace

        model = fleet_trace()[2]
        for field in ("steps", "decode_steps", "prefills",
                      "generated_tokens", "slot_steps", "mean_occupancy"):
            assert got["stats"][field] == model[field], field
        assert len(got["signatures"]["decode"]) == model[
            "dynamic_signatures"]
        assert sorted(static["signatures"]["decode"]) == model[
            "signature_keys"]


def _spec_runs():
    return [(w, s, geo) for w, shapes in ENGINE.items() for s in shapes
            for geo in ("rect", "paged")]


@pytest.mark.parametrize("world,shape,geo", _spec_runs(), ids=str)
def test_mesh_speculative_engine_reaches_the_committed_model(
        world, shape, geo, engine_ranks, engine_reference, inputs):
    """DecodeEngine(mesh=, speculative_k=3) with identity adapters (B = 0,
    m one card's row norm) on the committed speculative trace,
    rectangular and paged: streams and stats() equal the reference's
    single-device engine, the seven counters equal speculative_model (45
    drafts, 15 verifies, 63 accepted drafts); K8's plain version 2 x
    layers x (chunk + decode + draft + verify steps) on the paged engine;
    every rank returned the same. At model = 2 wo's and w_down's g comes
    from norm partials summed over the axis, so it may stand a few ulp
    from 1 (printed); the counters stay exact."""
    got = engine_ranks[world][f"engine_{shape}"][f"spec_identity_{geo}"]
    want = engine_reference[f"spec_identity_{geo}"]
    assert got["same_on_every_rank"]
    assert got["streams"] == want["streams"]
    assert got["stats"] == want["stats"]
    model = inputs["spec"]["model"]
    assert {f: got["stats"][f] for f in model} == model
    steps = got["device_steps"]
    assert (steps["draft"], steps["verify"]) == (45, 15)
    assert got["gathers"] == 2 * WIDTHS["num_layers"] * (
        steps["decode"] + steps["prefill_chunk"] + steps["draft"]
        + steps["verify"]) * (geo == "paged")
    if geo == "rect":
        print(f"max |g - 1| on {shape}: {got['g_dev']:.3e}")
        assert got["g_dev"] <= 1e-6


@pytest.mark.parametrize("world,shape", [(w, s) for w, shapes in
                                         ENGINE.items() for s in shapes],
                         ids=str)
def test_mesh_speculative_streams_equal_plain_decode(world, shape,
                                                     engine_ranks):
    """With the perturbed adapters some drafts miss: the speculative
    mesh engine's streams, rectangular and paged, equal the plain mesh
    engine's, and paged == rectangular, on every rank."""
    ranks = engine_ranks[world][f"engine_{shape}"]
    rect, paged, plain = (ranks[f"spec_perturbed_{g}"]
                          for g in ("rect", "paged", "plain"))
    assert rect["same_on_every_rank"] and paged["same_on_every_rank"]
    assert rect["streams"] == paged["streams"] == plain["streams"]
    st = rect["stats"]
    assert st["verify_steps"] > 0
    assert st["accepted_drafts"] < 3 * st["verify_steps"]
    assert paged["pool"]["used_blocks"] == 0


@pytest.mark.parametrize("world,shape", [(w, s) for w, shapes in
                                         ENGINE.items() for s in shapes],
                         ids=str)
def test_mesh_servers_speculate_and_group_dynamically_as_reference(
        world, shape, engine_ranks, engine_reference):
    """EngineServer(mesh=).run(speculative_k=3) of mixed prompt lengths
    under three handles through the paged engine, and
    MultiTenantServer(mesh=, dynamic_grouping=True) on the same requests,
    plain and with speculative_k=3: tokens, finish reasons, stats() and
    the cache's counts equal the reference's single-device servers; the
    server's engine decoded under "dynamic" alone; every rank returned
    the same."""
    ranks = engine_ranks[world][f"engine_{shape}"]
    got, want = ranks["spec_server"], engine_reference["spec_server"]
    assert got["same_on_every_rank"]
    assert got["reasons"] == want["reasons"] == ["length"] * len(SERVER_LENS)
    assert got["tokens"] == want["tokens"]
    assert got["stats"] == want["stats"]
    assert got["stats"]["verify_steps"] > 0
    _same_cache_counts(got["cache"], want["cache"])
    got = ranks["mt_dynamic_server"]
    want = engine_reference["mt_dynamic_server"]
    assert got["same_on_every_rank"]
    assert got["plain"] == want["plain"]
    assert got["speculative"] == want["speculative"] == got["plain"]
    _same_cache_counts(got["cache"], want["cache"])
    assert set(got["signatures"]["decode"]) == {"dynamic"}
    assert set(got["signatures"]["verify"]) <= {"('dynamic', 4)"}
