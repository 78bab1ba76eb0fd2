"""The MoE archs (qwen2-moe-a2.7b, llama4-scout-17b-a16e) through the
port's LM, train step, ``generate`` and CLIs against the reference.

Per arch, the SMOKE config's params and adapters are built by the
reference and perturbed with numpy (``test_torch_archs.perturbed_state``:
nonzero B, m off ||W||, biases and norm scales off their init), then
bridged into the port: logits within 1e-5 of max and the router loss
equal, adapter gradients within 1e-4 of max, three AdamW steps (eps 1e-4,
as in ``test_torch_train.py``) against the reference's ``make_train_step``,
4 equal greedy tokens from the padded ``generate``. Every routing decision
the port makes in these runs is checked for gaps between neighbours of a
token's k + 1 largest probabilities far above fp32 rounding, so an expert
flip can only be a fault of the port. The engine, multi-tenant grouping
and MoE every k-th layer stay refused, as in the reference.
"""
import dataclasses

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
from repro_torch.configs import get_config
from repro_torch.core.config import DoRAConfig
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.engine import DecodeEngine
from repro_torch.launch.steps import (StepConfig, make_grad_step,
                                      make_train_step)
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig
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

MOE_ARCHS = ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e"]
STEPS = 3
# The least gap between neighbouring top probabilities asserted: 16 fp32
# ulps of a probability near 1, where the two frameworks' logits agree to
# 1e-5 of max only after the whole stack.
MARGIN = 1e-6


@pytest.fixture
def routing(monkeypatch):
    """Record every routing decision of the port's MoE layers: the least
    gap between neighbours of a token's k + 1 largest probabilities (what
    would change its experts or their order), and the calls."""
    seen = {"calls": 0, "margin": float("inf")}
    inner = tmoe.router_topk

    def recording(x, w_router, cfg):
        probs = torch.softmax(x.detach().float() @ w_router.float().T, -1)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
        seen["margin"] = min(seen["margin"], float(
            (top[..., :-1] - top[..., 1:]).min()))
        seen["calls"] += 1
        return inner(x, w_router, cfg)
    monkeypatch.setattr(tmoe, "router_topk", recording)
    return seen


def _with_aux(jm, tm, coef):
    return (dataclasses.replace(jm, router_aux_coef=coef),
            dataclasses.replace(tm, router_aux_coef=coef))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_config_matches_reference(arch, smoke):
    t, j = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    names = [f.name for f in dataclasses.fields(t)]
    assert set(names) <= {f.name for f in dataclasses.fields(j)}
    for f in names:
        if f == "dtype":
            assert _dtype_name(t.dtype) == _dtype_name(j.dtype)
        else:
            assert getattr(t, f) == getattr(j, f), f
    assert t.ffn_kinds() == j.ffn_kinds() == ["moe"] * t.num_layers
    assert t.period == j.period == 1
    spec = {"/".join(p): leaf for p, leaf in
            tlm._spec_items(tlm.model_spec(t))}
    want = {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                jlm.model_spec(j), is_leaf=jlm._is_leaf_spec)[0]}
    assert spec == want
    total = sum(int(np.prod(shape)) * (t.n_scan if path[0] == "stack" else 1)
                for path, (_, shape) in tlm._spec_items(tlm.model_spec(t)))
    assert total == j.count_params()


@pytest.mark.parametrize("aux_coef", [0.0, 0.01], ids=["no_aux", "aux"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_logits_and_aux_match_reference(arch, aux_coef, routing):
    jm, tm, params, adapters = perturbed_state(arch)
    jm, tm = _with_aux(jm, tm, aux_coef)
    toks = np.random.default_rng(1).integers(0, jm.vocab_size, (BATCH, SEQ))
    dcfg = DoRAConfig(rank=RANK, alpha=ALPHA)
    jlogits, _, jaux = jlm.forward(
        jm, params, adapters, JConfig(rank=RANK, alpha=ALPHA, mode="eager"),
        tokens=jnp.asarray(toks), training=False)
    tlogits, _, taux = tlm.forward(
        tm, tree_from_numpy(params), tree_from_numpy(adapters), dcfg,
        tokens=torch.from_numpy(toks), training=False, return_aux=True)
    assert routing["calls"] == tm.num_layers
    assert routing["margin"] >= MARGIN, routing
    assert _rel(tlogits, jlogits) <= 1e-5
    if aux_coef:
        assert abs(float(taux) / float(jaux) - 1) <= 1e-6
    else:
        assert float(taux) == float(jaux) == 0.0
    # The two-value form is the same forward without the router loss.
    two = tlm.forward(tm, tree_from_numpy(params), tree_from_numpy(adapters),
                      dcfg, tokens=torch.from_numpy(toks), training=False)
    assert len(two) == 2 and torch.equal(two[0], tlogits)


@pytest.mark.parametrize("aux_coef", [0.0, 0.01], ids=["no_aux", "aux"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_adapter_grads_match_reference(arch, aux_coef, routing):
    """jax.grad of cross entropy + aux against the port's grad step (layer
    remat: the checkpoint's recompute routes as the forward did)."""
    jm, tm, params, adapters = perturbed_state(arch)
    jm, tm = _with_aux(jm, tm, aux_coef)
    toks = np.random.default_rng(2).integers(
        0, jm.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    want = reference_grads(jm, params, adapters,
                           {"tokens": jnp.asarray(toks[:, :-1])},
                           jnp.asarray(toks[:, 1:]))
    got = port_grads(tm, params, adapters,
                     {"tokens": torch.from_numpy(toks[:, :-1]).long(),
                      "labels": torch.from_numpy(toks[:, 1:]).long()})
    assert routing["calls"] == 2 * tm.num_layers      # forward + recompute
    assert routing["margin"] >= MARGIN, routing
    assert_grads_close(got, want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_remat_recompute_routes_as_the_forward(arch):
    """Layer remat and no remat give bitwise the same gradients: the
    recompute picks the same experts in the same order."""
    _, tm, params, adapters = perturbed_state(arch)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tm.vocab_size, (BATCH, SEQ + 1)))
    batch_in = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    grads = {}
    for remat in ("layer", "none"):
        step = make_grad_step(dataclasses.replace(tm, remat=remat),
                              StepConfig(dora=DoRAConfig(rank=RANK,
                                                         alpha=ALPHA)),
                              batch=BATCH, seq=SEQ)
        _, g = step(tree_from_numpy(params), tree_from_numpy(adapters),
                    batch_in)
        grads[remat] = flatten_paths(g)
    for name, g in grads["none"].items():
        assert torch.equal(grads["layer"][name], g), name


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_steps_match_reference(arch, routing):
    """Three make_train_step steps from bridged state: losses, gradient
    norms, and the adapters and AdamW moments after them."""
    jm, tm, params, adapters = perturbed_state(arch)
    opt = jax.tree_util.tree_map(np.array, jbuild_state(
        jm, JConfig(rank=RANK, alpha=ALPHA), 0)[2])
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=STEPS, eps=1e-4)
    jstep = jax.jit(jmake_train_step(
        jm, JStep(dora=JConfig(rank=RANK, alpha=ALPHA, mode="eager"),
                  optim=JOpt(**ocfg)), None, batch=BATCH, seq=SEQ))
    tstep = make_train_step(
        tm, StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA),
                       optim=OptimizerConfig(**ocfg)), batch=BATCH, seq=SEQ)
    jp, ja, jo = (jax.tree_util.tree_map(jnp.asarray, t)
                  for t in (params, adapters, opt))
    tp, ta, to = (tree_from_numpy(jax.tree_util.tree_map(np.array, t))
                  for t in (params, adapters, opt))
    toks = np.random.default_rng(4).integers(
        0, jm.vocab_size, (STEPS, BATCH, SEQ + 1)).astype(np.int32)
    for t in toks:
        batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        ja, jo, jmet = jstep(jp, ja, jo, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        ta, to, tmet = tstep(tp, ta, to, {k: torch.from_numpy(v).long()
                                          for k, v in batch.items()})
        assert abs(float(tmet["loss"]) / float(jmet["loss"]) - 1) <= 1e-5
        assert abs(float(tmet["grad_norm"]) / float(jmet["grad_norm"])
                   - 1) <= 1e-5
    assert routing["margin"] >= MARGIN, routing
    got = flatten_paths(tree_to_numpy({"adapters": ta, "opt": to}))
    want = flatten_paths(jax.tree_util.tree_map(np.asarray,
                                                {"adapters": ja, "opt": jo}))
    assert set(got) == set(want)
    for name in want:
        if name != "opt/count" and not name.endswith("base_sq"):
            assert _rel(got[name], want[name]) <= 1e-4, name


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_generate_matches_reference(arch, routing):
    """The padded prefill (capacity from the padded length, as the
    reference's) and 4 greedy tokens: logits within 1e-5 of max at every
    step, equal tokens."""
    jm, tm, params, adapters = perturbed_state(arch)
    prompts = np.random.default_rng(5).integers(0, jm.vocab_size,
                                                (BATCH, PROMPT))
    j_tok, j_logits = jserve.generate(
        jm, params, adapters,
        JStep(dora=JConfig(rank=RANK, alpha=ALPHA, mode="eager")), prompts,
        gen_len=GEN, max_len=SEQ, return_logits=True)
    t_tok, t_logits = tserve.generate(
        tm, tree_from_numpy(params), tree_from_numpy(adapters),
        StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA)), prompts,
        gen_len=GEN, max_len=SEQ, return_logits=True, device="cpu")
    assert routing["margin"] >= MARGIN, routing
    for step in range(GEN):
        assert _rel(t_logits[step], j_logits[step]) <= 1e-5, step
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bridge_carries_moe_trees_both_ways(arch):
    """bf16 MoE params (router, stacked "linear3" experts, the shared
    expert and its gate) and adapters cross the bridge bit for bit both
    ways under the reference's leaf paths."""
    _, tm, params, adapters = perturbed_state(arch, dtype=jnp.bfloat16)
    tp, ta = tree_from_numpy(params), tree_from_numpy(adapters)
    spec_paths = {"/".join(p) for p, _ in tlm._spec_items(tlm.model_spec(tm))}
    assert set(flatten_paths(tp)) == spec_paths
    assert tp["stack"]["l0"]["ffn"]["gate"].shape == (
        tm.n_scan, tm.num_experts, tm.moe_d_ff, tm.d_model)
    for tree, t in ((params, tp), (adapters, ta)):
        back = flatten_paths(tree_to_numpy(t))
        for name, leaf in flatten_paths(tree).items():
            assert back[name].dtype == leaf.dtype, name
            assert back[name].tobytes() == np.asarray(leaf).tobytes(), name


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_clis_run_the_smoke_config_on_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "5", "--gen-len", "3"])
    assert "generated [2, 8] on cpu" in capsys.readouterr().out
    ttrain.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                 "2", "--batch", "2", "--seq", "16", "--log-every", "1"])
    assert "done: 2 steps" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--continuous"], ["--fleet", "2"],
                                  ["--tenants", "2"]],
                         ids=["continuous", "fleet", "tenants"])
def test_engine_and_grouped_serving_refuse_moe(argv):
    """As in the reference: the engine (continuous batching, fleet)
    refuses MoE FFNs, whose capacity dispatch couples the batch's rows,
    and grouped multi-tenant serving runs attention + dense-MLP layers
    only."""
    with pytest.raises(NotImplementedError, match="MoE|moe"):
        tserve.main(["--arch", "qwen2-moe-a2.7b", "--smoke", "--device",
                     "cpu", "--batch", "2", "--prompt-len", "5",
                     "--gen-len", "2", *argv])
    tm = get_config("qwen2-moe-a2.7b", smoke=True)
    params, _ = tserve.build_state(tm, DoRAConfig(rank=4), 0, "cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        DecodeEngine(tm, StepConfig(), params, slots=2, max_len=16,
                     adapters={}, device="cpu")


@pytest.mark.parametrize("d_out,d_in", [(2048, 2048), (5632, 2048),
                                        (2048, 5632), (5120, 5120),
                                        (1024, 5120)])
def test_norm_terms_split_covers_the_moe_shapes(d_out, d_in):
    """K1's d_in split at every adapted weight of both MoE archs."""
    _k1_split_covers(d_out, d_in)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_compose_mm_plans_cover_the_moe_shapes(arch):
    """K6's persistent schedule and K7's split at every d_out that the
    4096-row prefill and training step send to them (qwen2-moe's shared
    w_gate and w_up, 5632; llama4-scout's wq and wo, 5120), and nothing
    else above the crossover."""
    from repro_torch.core import dispatch
    mcfg = get_config(arch)
    dcfg = DoRAConfig(rank=384, alpha=192.0)
    fused = sorted({shape[0] for _, shape in tlm._adapted_paths(
        mcfg, tlm.DEFAULT_DORA_TARGETS)
        if dispatch.plan_compose(dcfg, training=True, rows=4096,
                                 d_out=shape[0], rank=384).matmul_fused})
    assert fused == ([5632] if arch == "qwen2-moe-a2.7b" else [5120])
    for n in fused:
        _mm_plans_cover(n)


def test_moe_every_kth_layer_is_refused():
    """MoE on every 2nd layer builds as the reference's does: a unit of
    two layers (attention + dense MLP, attention + MoE) whose spec equals
    the reference's. Refused: a depth that is no whole number of units
    (ValueError, where the reference's ``period`` asserts) and a top_k
    above the experts."""
    base = dataclasses.asdict(get_config("qwen2-moe-a2.7b", smoke=True))
    jbase = jget_config("qwen2-moe-a2.7b", smoke=True)
    tm = ModelConfig(**{**base, "moe_period": 2})
    jm = dataclasses.replace(jbase, moe_period=2)
    assert tm.period == jm.period == 2
    assert tlm.unit_kinds(tm) == [("attn", "mlp"), ("attn", "moe")]
    assert_spec_matches_reference(tm, jm)
    with pytest.raises(ValueError, match="MoE-every-2"):
        tlm.model_spec(dataclasses.replace(tm, num_layers=3))
    with pytest.raises(AssertionError):
        dataclasses.replace(jm, num_layers=3).period
    with pytest.raises(ValueError, match="top_k"):
        tlm.model_spec(ModelConfig(**{**base, "top_k": 9}))
