"""The training slice of the port against the reference.

Inputs, weights and adapters are made with numpy (or by the reference's
own init) and bridged into both packages. The reference runs its Pallas
kernels in interpret mode, the port runs its kernel route in forced mode,
where every kernel wrapper runs its plain version on CPU tensors. The
matmul-fused route is forced with ``mm_fused_max_rank=128`` (the rank
guard would otherwise send these few rows to the element-wise route, as
``tests/test_compose_mm.py`` does) and the element-wise route with
``compose_matmul_fused=False``.

Tolerances, always scaled to the reference's largest magnitude and never
elementwise: adapter gradients 1e-5 of it (fp32 sums in another order);
losses 1e-5 relative; adapters and AdamW moments after three steps 3e-5,
with the optimizer's eps raised to 1e-4 in that comparison. Adam's step
g/(sqrt(v) + eps) is of order one even for a gradient element of 1e-8,
so at eps = 1e-8 a gradient difference of 1e-7 of the largest gradient
moves an element by about 1 % of a full step: the reference's own eager
and kernel routes end 1e-4 of the largest adapter value apart after three
such steps. With eps = 1e-4 the step is smooth in g and both packages'
routes agree within 1.1e-5 (measured).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.core import adapter as jadapter
from repro.core import dispatch as jdispatch
from repro.core.config import DoRAConfig as JConfig
from repro.data import DataConfig as JData
from repro.data import make_train_iterator as jiter
from repro.launch.steps import StepConfig as JStep
from repro.launch.steps import make_train_step as jmake_train_step
from repro.launch.train import build_state as jbuild_state
from repro.models.config import ModelConfig as JModel
from repro.optim import OptimizerConfig as JOpt
from repro.optim import adamw as jadamw
from repro_torch import checkpoint as tckpt
from repro_torch.bridge import (flatten_paths, tree_from_numpy,
                                tree_to_numpy)
from repro_torch.core import adapter as tadapter
from repro_torch.core import dispatch as tdispatch
from repro_torch.core.config import FORCE_TIER_ENV, DoRAConfig
from repro_torch.data import DataConfig, make_train_iterator
from repro_torch.kernels import dora_compose, factored_norm, norm_assembly
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import (StepConfig, cross_entropy,
                                      make_train_step)
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimizerConfig, adamw_init, adamw_update
from repro_torch.optim import adamw as tadamw

WIDTHS = dict(name="train-2l", family="dense", num_layers=2, d_model=128,
              num_heads=2, num_kv_heads=1, d_ff=256, vocab_size=256,
              qkv_bias=True, attn_chunk=8)
RANK, ALPHA = 16, 32.0
BATCH, SEQ, STEPS = 2, 16, 3
ROUTES = {"mm": {"mm_fused_max_rank": 128},
          "elementwise": {"compose_matmul_fused": False}}
PLAIN = ((factored_norm, "norm_terms_plain"),
         (norm_assembly, "assemble_norm_plain"),
         (dora_compose, "compose_fwd_plain"),
         (dora_compose, "compose_fwd_dual_plain"),
         (dora_compose, "compose_bwd_plain"),
         (dora_compose, "compose_mm_fwd_plain"),
         (dora_compose, "compose_mm_bwd_plain"))


@pytest.fixture(autouse=True)
def _no_forced_tier(monkeypatch):
    for name in ("REPRO_FORCE_TIER", "REPRO_DORA_MODE", "REPRO_DORA_FUSED",
                 FORCE_TIER_ENV):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture
def plain_calls(monkeypatch):
    """Count the kernels' plain versions as the wrappers reach them."""
    calls = {}
    for mod, name in PLAIN:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    return calls


def _max_rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _state(seed=0):
    """The reference's build_state with nonzero B, m = ||W||·(1 + noise)
    and nonzero QKV biases, as numpy trees."""
    jm = JModel(**WIDTHS, dtype=jnp.float32)
    params, adapters, opt = map(_np_tree, jbuild_state(
        jm, JConfig(rank=RANK, alpha=ALPHA), seed))
    rng = np.random.default_rng(seed)
    for name, leaf in flatten_paths(adapters).items():
        if name.endswith("/B"):
            leaf[...] = 0.05 * rng.standard_normal(leaf.shape)
        elif name.endswith("/m"):
            leaf *= 1 + 0.01 * rng.standard_normal(leaf.shape).astype(
                np.float32)
    for name, leaf in flatten_paths(params).items():
        if name.endswith("_bias"):
            leaf[...] = 0.1 * rng.standard_normal(leaf.shape)
    return jm, params, adapters, opt


def _batches(steps=STEPS, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, WIDTHS["vocab_size"], (steps, BATCH, SEQ + 1)).astype(np.int32)
    return [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]


# --- the adapted layer ------------------------------------------------------

@pytest.mark.parametrize("route", ["eager", "mm", "elementwise",
                                   "frozen_m"])
def test_dora_linear_training_grads_match_reference(route, plain_calls):
    """Adapter (A, B, m) and input gradients of dora_linear(training=True)
    against jax.grad through repro.core.dora_linear."""
    rng = np.random.default_rng(0)
    d_out, d_in = 256, 128
    W = (rng.standard_normal((d_out, d_in)) / np.sqrt(d_in)).astype(
        np.float32)
    ad = {"A": (rng.uniform(-1, 1, (RANK, d_in)) / np.sqrt(d_in)).astype(
              np.float32),
          "B": (0.05 * rng.standard_normal((d_out, RANK))).astype(np.float32),
          "m": (np.linalg.norm(W, axis=1)
                * (1 + 0.01 * rng.standard_normal(d_out))).astype(np.float32)}
    x = rng.standard_normal((2, 24, d_in)).astype(np.float32)
    w_out = rng.standard_normal((2, 24, d_out)).astype(np.float32)
    extra = {"frozen_m": {"magnitude_trainable": False,
                          "mm_fused_max_rank": 128}}.get(
        route, ROUTES.get(route, {}))
    jmode, tmode = ("eager", "eager") if route == "eager" \
        else ("interpret", "fused")
    jcfg = JConfig(rank=RANK, alpha=ALPHA, mode=jmode, **extra)
    tcfg = DoRAConfig(rank=RANK, alpha=ALPHA, mode=tmode, **extra)

    def jloss(a, xx):
        y = jadapter.dora_linear(xx, jnp.asarray(W), a, jcfg, training=True)
        return jnp.sum(y * w_out)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in ad.items()}, jnp.asarray(x))
    tad = {k: torch.from_numpy(v.copy()).requires_grad_(True)
           for k, v in ad.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tadapter.dora_linear(xt, torch.from_numpy(W), tad, tcfg,
                             training=True)
    (y * torch.from_numpy(w_out)).sum().backward()
    for k in ("A", "B"):
        assert _max_rel(tad[k].grad, jg[k]) <= 1e-5, k
    assert _max_rel(xt.grad, jgx) <= 1e-5
    if route == "frozen_m":
        assert tad["m"].grad is None and not np.asarray(jg["m"]).any()
    else:
        assert _max_rel(tad["m"].grad, jg["m"]) <= 1e-5
    expect = {"eager": {},
              "mm": {"compose_mm_fwd_plain": 1, "compose_mm_bwd_plain": 1},
              "frozen_m": {"compose_mm_fwd_plain": 1,
                           "compose_mm_bwd_plain": 1},
              "elementwise": {"compose_fwd_dual_plain": 1,
                              "compose_bwd_plain": 1}}[route]
    if route != "eager":
        expect.update(norm_terms_plain=1, assemble_norm_plain=1)
    assert plain_calls == expect


def test_dispatch_rank_above_512_takes_the_elementwise_route():
    """r = 640 pads above 2·256 = 512: the element-wise route (K4/K5) in
    both packages; r = 384 takes the matmul-fused one (K6/K7)."""
    for rank, fused in ((640, False), (384, True)):
        t = tdispatch.plan_compose(DoRAConfig(rank=rank), training=True,
                                   rows=4096, d_out=18944, rank=rank)
        j = jdispatch.plan_compose(JConfig(rank=rank, mode="fused"),
                                   training=True, rows=4096, d_out=18944,
                                   rank=rank)
        assert t.tier is tdispatch.Tier.FUSED_BWD
        assert t.matmul_fused == j.matmul_fused == fused


# --- training steps ---------------------------------------------------------

@pytest.mark.parametrize("route,grad_accum,loss_tokens",
                         [("mm", 1, 8), ("elementwise", 2, None)])
def test_train_steps_match_reference(route, grad_accum, loss_tokens,
                                     plain_calls):
    """Three make_train_step steps from bridged state: losses, adapters and
    AdamW moments against the reference's, and the kernel launches per
    step of layer remat (the norm pair once per adapted module, the
    compose forward twice: the layer and its recompute)."""
    jm, params, adapters, opt = _state()
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=STEPS, eps=1e-4)
    kw = dict(loss_tokens=loss_tokens, grad_accum=grad_accum)
    jstep = jax.jit(jmake_train_step(
        jm, JStep(dora=JConfig(rank=RANK, alpha=ALPHA, mode="interpret",
                               **ROUTES[route]),
                  optim=JOpt(**ocfg), **kw), None, batch=BATCH, seq=SEQ))
    tstep = make_train_step(
        ModelConfig(**WIDTHS, dtype=torch.float32),
        StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA, mode="fused",
                                   **ROUTES[route]),
                   optim=OptimizerConfig(**ocfg), **kw),
        batch=BATCH, seq=SEQ)
    jp, ja, jo = (jax.tree_util.tree_map(jnp.asarray, t)
                  for t in (params, adapters, opt))
    tp, ta, to = (tree_from_numpy(_np_tree(t))
                  for t in (params, adapters, opt))
    for step, batch in enumerate(_batches()):
        ja, jo, jmet = jstep(jp, ja, jo, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        ta, to, tmet = tstep(tp, ta, to, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
        assert abs(float(tmet["loss"]) / float(jmet["loss"]) - 1) <= 1e-5
        assert abs(float(tmet["grad_norm"]) / float(jmet["grad_norm"])
                   - 1) <= 1e-5
        assert tmet["lr"] == pytest.approx(float(jmet["lr"]), rel=1e-6)
        assert int(to["count"]) == step + 1
    got = flatten_paths(tree_to_numpy({"adapters": ta, "opt": to}))
    want = flatten_paths(_np_tree({"adapters": ja, "opt": jo}))
    assert set(got) == set(want)
    for name in want:
        if name != "opt/count":
            assert _max_rel(got[name], want[name]) <= 3e-5, name
    # wk/wv (d_out 64, not a multiple of 128) take the eager route, norm
    # included, in both packages; the other five projections the kernels.
    per_step = STEPS * grad_accum * 5 * WIDTHS["num_layers"]
    compose = ({"compose_mm_fwd_plain": 2 * per_step,
                "compose_mm_bwd_plain": per_step} if route == "mm" else
               {"compose_fwd_dual_plain": 2 * per_step,
                "compose_bwd_plain": per_step})
    assert plain_calls == {"norm_terms_plain": per_step,
                           "assemble_norm_plain": per_step, **compose}
    assert all(not p.requires_grad and p.grad is None
               for p in flatten_paths(tp).values()), "base params got grads"
    assert not any(a.requires_grad for a in flatten_paths(ta).values())


@pytest.mark.parametrize("mode", ["fused", "eager"])
def test_remat_gives_the_same_gradients(mode):
    """Layer remat (checkpointed layers, norms passed in) and no remat
    give the same loss and adapter gradients."""
    _, params, adapters, _ = _state(1)
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    dcfg = DoRAConfig(rank=RANK, alpha=ALPHA, mode=mode, **ROUTES["mm"])
    out = {}
    for remat in ("layer", "none"):
        mcfg = ModelConfig(**WIDTHS, dtype=torch.float32, remat=remat)
        ta = tree_from_numpy(_np_tree(adapters))
        leaves = list(flatten_paths(ta).values())
        for leaf in leaves:
            leaf.requires_grad_(True)
        logits, _ = tlm.forward(mcfg, tree_from_numpy(params), ta, dcfg,
                                tokens=batch["tokens"], training=True)
        loss = cross_entropy(logits, batch["labels"])
        out[remat] = (loss.item(), torch.autograd.grad(loss, leaves))
    assert out["layer"][0] == pytest.approx(out["none"][0], rel=1e-6)
    for a, b in zip(out["layer"][1], out["none"][1]):
        assert _max_rel(a, b) <= 1e-6


# --- AdamW ------------------------------------------------------------------

def test_adamw_schedule_clip_and_decay_mask_match_reference():
    cfg = dict(lr=3e-3, warmup_steps=4, total_steps=12, clip_norm=0.5,
               weight_decay=0.1)
    for step in range(0, 15):
        want = float(jadamw.cosine_warmup_schedule(JOpt(**cfg), step))
        assert tadamw.cosine_warmup_schedule(OptimizerConfig(**cfg),
                                             step) == pytest.approx(
            want, rel=1e-6, abs=0)
    rng = np.random.default_rng(3)
    tree = {"l": {"A": rng.standard_normal((4, 8)).astype(np.float32),
                  "m": rng.standard_normal(8).astype(np.float32),
                  "base_sq": np.abs(rng.standard_normal(8)).astype(
                      np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda a: (3 * rng.standard_normal(a.shape)).astype(np.float32),
        tree) for _ in range(3)]
    grads[0]["l"]["base_sq"][...] = 0.0
    jp, jst = jax.tree_util.tree_map(jnp.asarray, tree), None
    jst = jadamw.adamw_init(jp)
    tp = tree_from_numpy(_np_tree(tree))
    tst = adamw_init(tp)
    assert set(flatten_paths(tst)) == set(flatten_paths(_np_tree(jst)))
    for g in grads:
        jp, jst, jstats = jadamw.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, g), jst, jp, JOpt(**cfg))
        tp, tst, tstats = adamw_update(tree_from_numpy(_np_tree(g)), tst,
                                       tp, OptimizerConfig(**cfg))
        assert float(tstats["grad_norm"]) == pytest.approx(
            float(jstats["grad_norm"]), rel=1e-6)
        assert tstats["lr"] == pytest.approx(float(jstats["lr"]), rel=1e-6)
    got = flatten_paths(tree_to_numpy({"p": tp, "s": tst}))
    want = flatten_paths(_np_tree({"p": jp, "s": jst}))
    for name in want:
        assert _max_rel(got[name], want[name]) <= 1e-6, name
    # The decay mask: with zero gradients only A decays.
    zero = tree_from_numpy(jax.tree_util.tree_map(np.zeros_like, tree))
    p = tree_from_numpy(_np_tree(tree))
    adamw_update(zero, adamw_init(p), p, OptimizerConfig(**cfg))
    assert not torch.equal(p["l"]["A"], torch.from_numpy(tree["l"]["A"]))
    for k in ("m", "base_sq"):
        assert torch.equal(p["l"][k], torch.from_numpy(tree["l"][k]))
    # The clip: fp32 arithmetic, cast back to each gradient's dtype.
    g16 = {"a": torch.full((4,), 3.0, dtype=torch.bfloat16),
           "b": torch.full((4,), 4.0)}
    clipped, norm = tadamw.clip_by_global_norm(g16, 1.0)
    assert float(norm) == 10.0 and clipped["a"].dtype == torch.bfloat16
    assert float(clipped["b"][0]) == pytest.approx(0.4)


# --- checkpoints and data ---------------------------------------------------

def test_checkpoints_restore_across_packages(tmp_path):
    """The port writes what repro.checkpoint.restore_checkpoint reads, and
    reads what the reference writes: same leaf names, manifest and
    LATEST. bf16 leaves round-trip in the port bit for bit."""
    _, _, adapters, opt = _state()
    state = {"adapters": adapters, "opt": opt}
    t_cfg = tckpt.CheckpointConfig(str(tmp_path / "port"))
    j_cfg = jckpt.CheckpointConfig(str(tmp_path / "port"))
    tstate = tree_from_numpy(_np_tree(state))
    tckpt.save_checkpoint(t_cfg, 3, tstate, mesh_meta={"model": 1})
    restored, step = jckpt.restore_checkpoint(j_cfg, _np_tree(state))
    assert step == 3 and jckpt.latest_step(j_cfg) == 3
    for name, leaf in flatten_paths(_np_tree(restored)).items():
        np.testing.assert_array_equal(leaf, flatten_paths(state)[name])
    assert restored["opt"]["count"].dtype == np.int32

    j_cfg = jckpt.CheckpointConfig(str(tmp_path / "ref"), keep=2)
    for s in (1, 2, 5):
        jckpt.save_checkpoint(j_cfg, s, state)
    t_cfg = tckpt.CheckpointConfig(str(tmp_path / "ref"), keep=2)
    assert tckpt.latest_step(t_cfg) == 5
    back, step = tckpt.restore_checkpoint(t_cfg, tstate)
    assert step == 5
    for name, leaf in flatten_paths(back).items():
        assert torch.equal(leaf, flatten_paths(tstate)[name]), name
    assert sorted(p.name for p in (tmp_path / "ref").iterdir()) == [
        "LATEST", "step_00000002", "step_00000005"]
    assert tckpt.restore_checkpoint(
        tckpt.CheckpointConfig(str(tmp_path / "none")), tstate) == (None,
                                                                    None)

    bf = {"w": torch.randn(5, 3).to(torch.bfloat16),
          "c": torch.zeros((), dtype=torch.int32)}
    b_cfg = tckpt.CheckpointConfig(str(tmp_path / "bf16"))
    tckpt.save_checkpoint(b_cfg, 1, bf)
    back, _ = tckpt.restore_checkpoint(b_cfg, {k: torch.empty_like(v)
                                               for k, v in bf.items()})
    assert torch.equal(back["w"], bf["w"])
    manifest = (tmp_path / "bf16" / "step_00000001" / "MANIFEST.json")
    assert '"bfloat16"' in manifest.read_text()


def test_bridge_carries_optimizer_state_both_ways():
    """The reference's AdamW state (fp32 moments, an int32 0-d count) and
    bf16 adapters cross into the port and back exactly, 0-d shapes
    kept."""
    _, _, adapters, opt = _state()
    opt["count"] = np.asarray(np.int32(7))
    bf = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), adapters)
    tree = {"adapters": bf, "opt": opt}
    t = tree_from_numpy(tree)
    assert t["opt"]["count"].shape == () and int(t["opt"]["count"]) == 7
    assert t["adapters"]["stack"]["l0"]["ffn"]["w_up"]["A"].dtype == \
        torch.bfloat16
    back = flatten_paths(tree_to_numpy(t))
    for name, leaf in flatten_paths(tree).items():
        assert back[name].dtype == leaf.dtype and \
            back[name].shape == leaf.shape, name
        assert back[name].tobytes() == np.asarray(leaf).tobytes(), name


def test_data_pipeline_gives_the_reference_batches():
    for start in (0, 5):
        jit_ = jiter(JData(vocab_size=300, seq_len=24, global_batch=4,
                           seed=7), start_step=start, process_index=1,
                     process_count=2)
        tit = make_train_iterator(DataConfig(vocab_size=300, seq_len=24,
                                             global_batch=4, seed=7),
                                  start_step=start, process_index=1,
                                  process_count=2)
        for _ in range(3):
            want, got = next(jit_), next(tit)
            assert set(got) == set(want) == {"tokens", "labels"}
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


# --- the CLI ----------------------------------------------------------------

def test_cli_trains_the_smoke_config_on_cpu(tmp_path, capsys):
    ttrain.main(["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
                 "--steps", "2", "--log-every", "1", "--ckpt-dir",
                 str(tmp_path)])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "step     1 loss" in out
    assert "done: 2 steps" in out
    assert tckpt.latest_step(tckpt.CheckpointConfig(str(tmp_path))) == 2
    ttrain.main(["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
                 "--steps", "3", "--ckpt-dir", str(tmp_path), "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "done: 1 steps" in out


def test_cli_without_device_raises_on_a_host_without_cuda():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parents[1] / "src")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-7b", "--smoke", "--steps", "1"], capture_output=True,
        text=True, timeout=120, env=env)
    assert out.returncode != 0 and "CUDA unavailable" in out.stderr


def test_serving_state_is_refused_and_stacked_config_fields():
    """A tree carrying serving state ("g") is refused under training; the
    port's ModelConfig carries the reference's remat default."""
    assert ModelConfig(**WIDTHS).remat == JModel(**WIDTHS).remat == "layer"
    assert {f.name for f in dataclasses.fields(StepConfig)} == {
        f.name for f in dataclasses.fields(JStep)}
    rng = np.random.default_rng(5)
    W = torch.from_numpy(rng.standard_normal((128, 32)).astype(np.float32))
    ad = tadapter.init_dora_params(W, DoRAConfig(rank=4),
                                   generator=torch.Generator())
    state = tadapter.precompute_adapter_state({"w": W}, {"w": ad},
                                              DoRAConfig(rank=4))["w"]
    with pytest.raises(ValueError, match="precomputed serving state"):
        tadapter.dora_linear(torch.zeros(2, 32), W, state,
                             DoRAConfig(rank=4), training=True)


def test_build_state_defaults_to_the_card_not_the_cpu():
    """``build_state`` without a device means the card: with no card here
    it raises, and the CPU is built only when it is asked for."""
    mcfg, dcfg = ModelConfig(**WIDTHS), DoRAConfig(rank=RANK, alpha=ALPHA)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA unavailable"):
            ttrain.build_state(mcfg, dcfg, 0)
    state = ttrain.build_state(mcfg, dcfg, 0, device="cpu")
    leaves = [v for tree in state for v in flatten_paths(tree).values()
              if isinstance(v, torch.Tensor)]
    assert leaves and all(t.device.type == "cpu" for t in leaves)
