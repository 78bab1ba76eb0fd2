"""The hybrid jamba-v0.1-52b through the port's LM, train step,
``generate`` and CLIs against the reference.

Jamba's stack repeats a unit of 8 layers (lcm of ``attn_period`` 8 and
``moe_period`` 2): seven Mamba-1 mixers and one attention mixer at index
4 with no positional encoding (NoPE), a dense SwiGLU MLP on the even
layers and MoE (top-2) on the odd ones. The reference's SMOKE config (8
layers, d_model 64, 4 experts, capacity factor 8, fp32) runs at its own
depth (one unit) and at 16 layers (two units, so the unit loop runs
twice): the reference's params and adapters, perturbed with numpy
(``test_torch_archs.perturbed_state``), are bridged into the port as
copies. Tolerances, scaled to the reference's largest magnitude as in the
other ``test_torch_*`` files: logits 1e-5 of max and the router loss
1e-6 relative, adapter gradients 1e-4 of max, three AdamW steps (eps
1e-4) losses and gradient norms 1e-5 relative, adapters and moments
after them 1e-4 of max, ``generate``'s logits 1e-5 of max at every step
and equal tokens. Every routing the port does asserts a least gap of
``MARGIN`` between neighbours of a token's k + 1 largest probabilities,
so an expert flip can only be a fault of the port. The engine, grouped
multi-tenant serving and the CLI modes built on them keep refusing
jamba, as the reference's do.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.config import DoRAConfig as JConfig
from repro.launch import serve as jserve
from repro.launch.steps import StepConfig as JStep
from repro.launch.steps import make_train_step as jmake_train_step
from repro.launch.train import build_state as jbuild_state
from repro.models import lm as jlm
from repro.optim import OptimizerConfig as JOpt
from repro_torch.bridge import flatten_paths, tree_from_numpy, tree_to_numpy
from repro_torch.checkpoint.store import (CheckpointConfig,
                                          restore_checkpoint,
                                          save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.core.config import DoRAConfig
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.engine import DecodeEngine
from repro_torch.launch.steps import (StepConfig, make_grad_step,
                                      make_train_step)
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.optim import OptimizerConfig
from test_torch_archs import (ALPHA, BATCH, GEN, PROMPT, RANK, SEQ,
                              _dtype_name, _no_forced_tier,  # noqa: F401
                              _rel, assert_grads_close,
                              assert_spec_matches_reference, perturbed_state,
                              port_grads, reference_grads)
from test_torch_archs import \
    test_compose_mm_plans_cover_the_new_shapes as _mm_plans_cover
from test_torch_archs import \
    test_norm_terms_split_covers_the_new_shapes as _k1_split_covers
from test_torch_moe_lm import MARGIN, routing  # noqa: F401

ARCH = "jamba-v0.1-52b"
STEPS = 3
AUX = 0.01
# The SMOKE depth (one unit) and two units.
DEPTHS = [8, 16]
UNIT = [("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"),
        ("mamba", "moe"), ("attn", "mlp"), ("mamba", "moe"),
        ("mamba", "mlp"), ("mamba", "moe")]


@functools.lru_cache(maxsize=None)
def _state(layers: int):
    return perturbed_state(ARCH, layers=layers)


def jamba(layers: int, aux: float = AUX):
    """The reference's and the port's SMOKE configs at ``layers`` with the
    router loss weighted by ``aux``, and fresh numpy copies of the
    perturbed params and adapters (each package gets its own arrays)."""
    jm, tm, params, adapters = _state(layers)
    copy = functools.partial(jax.tree_util.tree_map, np.array)
    return (dataclasses.replace(jm, router_aux_coef=aux),
            dataclasses.replace(tm, router_aux_coef=aux),
            copy(params), copy(adapters))


def port(tree):
    """A numpy tree bridged into the port as a copy: the port's in-place
    updates never reach an array the reference reads."""
    return tree_from_numpy(jax.tree_util.tree_map(np.array, tree))


def _moe_layers(tm) -> int:
    return sum(f == "moe" for f in tm.ffn_kinds())


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_matches_reference(smoke):
    """Field by field, ``period``, the layer and FFN kinds, ``count_params``
    and the spec, at the config's depth and at 16 layers (SMOKE) or 16 of
    32 (the chip's cut)."""
    t, j = get_config(ARCH, smoke=smoke), jget_config(ARCH, smoke=smoke)
    names = [f.name for f in dataclasses.fields(t)]
    assert set(names) <= {f.name for f in dataclasses.fields(j)}
    for f in names:
        if f == "dtype":
            assert _dtype_name(t.dtype) == _dtype_name(j.dtype)
        else:
            assert getattr(t, f) == getattr(j, f), f
    for layers in (t.num_layers, 16):
        tl = dataclasses.replace(t, num_layers=layers)
        jl = dataclasses.replace(j, num_layers=layers)
        assert tl.period == jl.period == 8 and not tl.is_uniform
        assert tl.n_scan == layers // 8
        assert tl.layer_kinds() == jl.layer_kinds()
        assert tl.ffn_kinds() == jl.ffn_kinds()
        assert tlm.unit_kinds(tl) == UNIT
        assert tl.count_params() == jl.count_params()
        assert_spec_matches_reference(tl, jl)
        total = sum(int(np.prod(shape))
                    * (tl.n_scan if path[0] == "stack" else 1)
                    for path, (_, shape) in tlm._spec_items(
                        tlm.model_spec(tl)))
        assert total == jl.count_params()
    if not smoke:
        assert t.count_params() == 51_570_315_264


def test_adapted_modules_match_reference():
    """The attention projections at index 4, in_proj and out_proj on the
    Mamba layers, the dense MLP's three on the even layers; the routed
    experts and the router stay frozen, and there is no shared expert."""
    t, j = get_config(ARCH), jget_config(ARCH)
    got = [("/".join(p), tuple(s)) for p, s in
           tlm._adapted_paths(t, tlm.DEFAULT_DORA_TARGETS)]
    want = [("/".join(p), tuple(s)) for p, s in
            jlm._adapted_paths(j, jlm.DEFAULT_DORA_TARGETS)]
    assert sorted(got) == sorted(want) and len(got) == 30
    names = {p.split("/")[-1] for p, _ in got}
    assert names == {"wq", "wk", "wv", "wo", "in_proj", "out_proj",
                     "w_gate", "w_up", "w_down"}
    assert all(p.startswith("l4/") for p, _ in got
               if p.split("/")[-1] in ("wq", "wk", "wv", "wo"))
    assert not any("/ffn/" in p and p.split("/")[0] in
                   ("l1", "l3", "l5", "l7") for p, _ in got)


def test_nope_attention_rotates_nothing():
    """``pos_mode="none"``: q and k leave ``position_rotation`` as they
    came, whatever the positions."""
    t = get_config(ARCH, smoke=True)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 5, 4, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 5, 2, 16)).astype(
        np.float32))
    for pos in (torch.zeros(2, 5, dtype=torch.long),
                torch.from_numpy(rng.integers(0, 4096, (2, 5)))):
        rq, rk = tlayers.position_rotation(q, k, pos, t)
        assert torch.equal(rq, q) and torch.equal(rk, k)


@pytest.mark.parametrize("layers", DEPTHS)
def test_cache_shapes_match_reference(layers):
    """One unit's cache holds attention K/V at l4 and the Mamba h/conv
    states at the other seven, stacked [n_scan, ...]; the paged cache
    stays refused (attention-only)."""
    jm = dataclasses.replace(jget_config(ARCH, smoke=True),
                             num_layers=layers)
    tm = dataclasses.replace(get_config(ARCH, smoke=True), num_layers=layers)
    got = tlm.cache_shapes(tm, 2, 32)
    want = jlm.cache_shapes(jm, 2, 32)
    assert got["len"][0] == want["len"].shape == ()
    got, want = flatten_paths(got["stack"]), flatten_paths(want["stack"])
    assert set(got) == set(want)
    for name, w in want.items():
        shape, dt = got[name]
        assert tuple(shape) == tuple(w.shape), name
        assert _dtype_name(dt) == jnp.dtype(w.dtype).name, name
    assert got["l4/k"][0][0] == layers // 8
    assert set(tlm.cache_shapes(tm, 2, 32)["stack"]["l0"]) == {"h", "conv"}
    with pytest.raises(ValueError, match="attention-only"):
        tlm.cache_shapes(tm, 2, 32, row_lens=True, block_size=8)


@pytest.mark.parametrize("layers", DEPTHS)
def test_logits_and_aux_match_reference(layers, routing):
    """The router loss sums over the four MoE layers of each unit."""
    jm, tm, params, adapters = jamba(layers)
    toks = np.random.default_rng(1).integers(0, jm.vocab_size, (BATCH, SEQ))
    jlogits, _, jaux = jlm.forward(
        jm, params, adapters, JConfig(rank=RANK, alpha=ALPHA, mode="eager"),
        tokens=jnp.array(toks), training=False)
    tlogits, _, taux = tlm.forward(
        tm, port(params), port(adapters), DoRAConfig(rank=RANK, alpha=ALPHA),
        tokens=torch.from_numpy(toks), training=False, return_aux=True)
    assert routing["calls"] == _moe_layers(tm) == layers // 2
    assert routing["margin"] >= MARGIN, routing
    assert _rel(tlogits, jlogits) <= 1e-5
    assert float(jaux) > 0
    assert abs(float(taux) / float(jaux) - 1) <= 1e-6


def test_adapter_grads_match_reference(routing):
    """One unit: jax.grad of cross entropy + router loss against the
    port's grad step (layer remat: each MoE layer routes twice, forward
    and recompute). Two units' gradients are held through the first train
    step (``test_train_steps_match_reference``), which saves the
    reference a second 25 s compile."""
    layers = 8
    jm, tm, params, adapters = jamba(layers)
    toks = np.random.default_rng(2).integers(
        0, jm.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    want = reference_grads(jm, params, adapters,
                           {"tokens": jnp.array(toks[:, :-1])},
                           jnp.array(toks[:, 1:]))
    got = port_grads(tm, *jamba(layers)[2:],
                     {"tokens": torch.from_numpy(toks[:, :-1]).long(),
                      "labels": torch.from_numpy(toks[:, 1:]).long()})
    assert routing["calls"] == 2 * _moe_layers(tm)
    assert routing["margin"] >= MARGIN, routing
    assert_grads_close(got, want)


def test_remat_recompute_routes_as_the_forward():
    """At two units, layer remat and no remat give bitwise the same
    gradients: each MoE layer's recompute picks the experts its forward
    picked, in the same order."""
    _, tm, params, adapters = jamba(16)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tm.vocab_size, (BATCH, SEQ + 1)))
    batch_in = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    grads = {}
    for remat in ("layer", "none"):
        step = make_grad_step(dataclasses.replace(tm, remat=remat),
                              StepConfig(dora=DoRAConfig(rank=RANK,
                                                         alpha=ALPHA)),
                              batch=BATCH, seq=SEQ)
        _, g = step(port(params), port(adapters), batch_in)
        grads[remat] = flatten_paths(g)
    for name, g in grads["none"].items():
        assert torch.equal(grads["layer"][name], g), name


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda x: np.array(x, np.float64 if np.issubdtype(
            np.asarray(x).dtype, np.floating) else None), tree)


def _leaves_rel(got, want) -> dict:
    got, want = flatten_paths(got), flatten_paths(want)
    assert set(got) == set(want)
    return {name: _rel(got[name], want[name]) for name in want
            if name != "opt/count" and not name.endswith("base_sq")}


# Per step (loss and grad norm relative, adapter and moment leaves of
# max): the first step as every other arch's; after it, AdamW at lr 1e-2
# moves the adapters by about lr an element and amplifies fp32 rounding.
# At 16 layers both fp32 packages drift from the port's fp64 run by as
# much as they differ from each other (``pytest -s`` prints each one's
# drift a step), so two units are held that far after the first step.
STEP_TOL = {8: ((1e-5, 1e-4),) * 3,
            16: ((1e-5, 1e-4), (1e-4, 1e-3), (1e-4, 1e-3))}


@pytest.mark.parametrize("layers", DEPTHS)
def test_train_steps_match_reference(layers, routing):
    """Three make_train_step steps from bridged state, each held after it:
    loss, gradient norm, and the adapters and AdamW moments (the first
    step's mu is (1 - beta1) times the clipped gradient, so the 16-layer
    gradients are held here). At 16 layers the port's fp64 run is held
    to the reference as well, and each fp32 package's drift from it is
    printed."""
    jm, tm, params, adapters = jamba(layers)
    opt = jax.tree_util.tree_map(np.array, jbuild_state(
        jm, JConfig(rank=RANK, alpha=ALPHA), 0)[2])
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=STEPS, eps=1e-4)
    jstep = jax.jit(jmake_train_step(
        jm, JStep(dora=JConfig(rank=RANK, alpha=ALPHA, mode="eager"),
                  optim=JOpt(**ocfg)), None, batch=BATCH, seq=SEQ))
    scfg = StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA),
                      optim=OptimizerConfig(**ocfg))
    runs = {"fp32": (tm, (params, adapters, opt))}
    if layers > 8:
        runs["fp64"] = (dataclasses.replace(tm, dtype=torch.float64),
                        (_f64(params), _f64(adapters), _f64(opt)))
    steps = {k: make_train_step(m, scfg, batch=BATCH, seq=SEQ)
             for k, (m, _) in runs.items()}
    state = {k: tuple(port(t) for t in trees)
             for k, (_, trees) in runs.items()}
    jp, ja, jo = (jax.tree_util.tree_map(jnp.array, t)
                  for t in (params, adapters, opt))
    toks = np.random.default_rng(4).integers(
        0, jm.vocab_size, (STEPS, BATCH, SEQ + 1)).astype(np.int32)
    for i, (t, (tol, leaf_tol)) in enumerate(zip(toks, STEP_TOL[layers])):
        batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        ja, jo, jmet = jstep(jp, ja, jo, {k: jnp.array(v)
                                          for k, v in batch.items()})
        want = {"adapters": jax.tree_util.tree_map(np.asarray, ja),
                "opt": jax.tree_util.tree_map(np.asarray, jo)}
        got = {}
        for k, (tp, ta, to) in state.items():
            ta, to, tmet = steps[k](tp, ta, to, {
                k2: torch.from_numpy(v).long() for k2, v in batch.items()})
            state[k] = (tp, ta, to)
            got[k] = (tmet, tree_to_numpy({"adapters": ta, "opt": to}))
            for m in ("loss", "grad_norm"):
                assert abs(float(tmet[m]) / float(jmet[m]) - 1) <= tol, \
                    (k, m)
            rel = _leaves_rel(got[k][1], want)
            assert max(rel.values()) <= leaf_tol, (k, max(rel.items(),
                                                          key=lambda x: x[1]))
        if "fp64" in got:
            met64, tree64 = got["fp64"]
            drift = {who: {**{m: abs(float(met[m]) / float(met64[m]) - 1)
                              for m in ("loss", "grad_norm")},
                           "leaves": max(_leaves_rel(tree, tree64).values())}
                     for who, (met, tree) in (("reference", (jmet, want)),
                                              ("port", got["fp32"]))}
            print(f"step {i}: fp32 drift from the port's fp64 run {drift}")
    assert routing["margin"] >= MARGIN, routing


@pytest.mark.parametrize("layers", DEPTHS)
def test_generate_matches_reference(layers, routing, monkeypatch):
    """``generate`` prefills at the exact prompt length (the Mamba states
    cannot rewind a padded prefill), as the reference's does, then 4
    greedy tokens: logits within 1e-5 of max at every step, equal
    tokens."""
    jm, tm, params, adapters = jamba(layers, aux=0.0)
    seen = []
    inner = tserve.make_prefill_step

    def recording(*args, **kw):
        seen.append(kw.get("padded", False))
        return inner(*args, **kw)
    monkeypatch.setattr(tserve, "make_prefill_step", recording)
    prompts = np.random.default_rng(5).integers(0, jm.vocab_size,
                                                (BATCH, PROMPT))
    j_tok, j_logits = jserve.generate(
        jm, params, adapters,
        JStep(dora=JConfig(rank=RANK, alpha=ALPHA, mode="eager")), prompts,
        gen_len=GEN, max_len=SEQ, return_logits=True)
    t_tok, t_logits = tserve.generate(
        tm, port(params), port(adapters),
        StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA)), prompts,
        gen_len=GEN, max_len=SEQ, return_logits=True, device="cpu")
    assert seen == [False]
    assert routing["margin"] >= MARGIN, routing
    for step in range(GEN):
        assert _rel(t_logits[step], j_logits[step]) <= 1e-5, step
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))


def test_bridge_carries_jamba_trees_both_ways():
    """bf16 params and adapters of two units (Mamba mixers, the attention
    at l4, dense MLPs, the router and stacked experts) cross the bridge
    bit for bit both ways under the reference's leaf paths, the unit's
    keys l0..l7 in order."""
    _, tm, params, adapters = perturbed_state(ARCH, dtype=jnp.bfloat16,
                                              layers=16)
    tp, ta = port(params), port(adapters)
    spec_paths = {"/".join(p) for p, _ in tlm._spec_items(tlm.model_spec(tm))}
    assert set(flatten_paths(tp)) == spec_paths
    assert list(tp["stack"]) == [f"l{i}" for i in range(8)]
    assert tp["stack"]["l1"]["ffn"]["gate"].shape == (
        2, tm.num_experts, tm.moe_d_ff, tm.d_model)
    for tree, t in ((params, tp), (adapters, ta)):
        back = flatten_paths(tree_to_numpy(t))
        for name, leaf in flatten_paths(tree).items():
            assert back[name].dtype == leaf.dtype, name
            assert back[name].tobytes() == np.asarray(leaf).tobytes(), name


def test_checkpoint_and_key_order_keep_the_unit(tmp_path):
    """Two units' adapters through the checkpoint store come back bitwise
    with the unit's keys l0..l7 in order; ``forward`` finds each layer by
    its name, so a unit whose keys come in another order gives the same
    logits."""
    _, tm, params, adapters = jamba(16)
    ta = port(adapters)
    cfg = CheckpointConfig(str(tmp_path))
    save_checkpoint(cfg, 1, {"adapters": ta})
    restored, step = restore_checkpoint(cfg, {"adapters": port(adapters)})
    assert step == 1
    assert list(restored["adapters"]["stack"]) == [f"l{i}" for i in range(8)]
    got, want = flatten_paths(restored), flatten_paths({"adapters": ta})
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, tm.vocab_size, (BATCH, SEQ)))
    dcfg = DoRAConfig(rank=RANK, alpha=ALPHA)
    tp = port(params)
    logits, _ = tlm.forward(tm, tp, ta, dcfg, tokens=toks, training=False)
    shuffled = {**tp, "stack": dict(reversed(list(tp["stack"].items())))}
    again, _ = tlm.forward(tm, shuffled, restored["adapters"], dcfg,
                           tokens=toks, training=False)
    assert torch.equal(logits, again)


@pytest.mark.parametrize("layers", DEPTHS)
def test_clis_run_the_smoke_config_on_cpu(layers, monkeypatch, capsys):
    """Both CLIs with ``--arch jamba-v0.1-52b --smoke --device cpu``; at
    16 layers through the SMOKE config at that depth."""
    smoke = dataclasses.replace(get_config(ARCH, smoke=True),
                                num_layers=layers)
    for mod in (tserve, ttrain):
        monkeypatch.setattr(mod, "get_config", lambda *a, **kw: smoke)
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "5", "--gen-len", "3"])
    assert "generated [2, 8] on cpu" in capsys.readouterr().out
    ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                 "2", "--batch", "2", "--seq", "16", "--log-every", "1"])
    assert "done: 2 steps" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--continuous"], ["--fleet", "2"],
                                  ["--tenants", "2"]],
                         ids=["continuous", "fleet", "tenants"])
def test_engine_and_grouped_serving_refuse_jamba(argv):
    """As in the reference: the engine (``--continuous``, ``--fleet``)
    refuses the Mamba states, which cannot rewind to a slot's prompt, and
    grouped multi-tenant serving (``--tenants``) runs attention +
    dense-MLP layers only."""
    with pytest.raises(NotImplementedError,
                       match="attention-only|attention \\+ dense-MLP"):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "5", "--gen-len", "2",
                     *argv])


def test_engine_and_grouped_forward_refuse_jamba():
    tm = get_config(ARCH, smoke=True)
    params, adapters = tserve.build_state(tm, DoRAConfig(rank=4), 0, "cpu")
    with pytest.raises(NotImplementedError, match="attention-only"):
        DecodeEngine(tm, StepConfig(), params, slots=2, max_len=16,
                     adapters={}, device="cpu")
    with pytest.raises(NotImplementedError, match="mamba layer"):
        tlm.forward(tm, params, adapters, DoRAConfig(rank=4),
                    tokens=torch.zeros((2, 3), dtype=torch.long),
                    training=False, tenant_groups=((0, 2),))


@pytest.mark.parametrize("d_out,d_in", [(14336, 4096), (4096, 14336),
                                        (1024, 4096)])
def test_norm_terms_split_covers_the_jamba_shapes(d_out, d_in):
    """K1's d_in split at jamba's three weight shapes new to the card
    (w_gate/w_up, w_down, wk/wv)."""
    _k1_split_covers(d_out, d_in)


def test_compose_mm_plans_cover_the_jamba_shapes():
    """The d_out that the 4096-row prefill and training step send to K6
    and K7: wq/wo/out_proj/w_down 4096, w_gate/w_up 14336 (new to the
    card) and in_proj 16384 (K6's and K7's schedules at 4096 rows); wk
    and wv (1024) stay below the crossover."""
    from repro_torch.core import dispatch
    dcfg = DoRAConfig(rank=384, alpha=192.0)
    fused = sorted({shape[0] for _, shape in tlm._adapted_paths(
        get_config(ARCH), tlm.DEFAULT_DORA_TARGETS)
        if dispatch.plan_compose(dcfg, training=True, rows=4096,
                                 d_out=shape[0], rank=384).matmul_fused})
    assert fused == [4096, 14336, 16384]
    for n in (14336, 16384):
        _mm_plans_cover(n)
