"""The whole serving slice of the port against the reference.

A 2-layer model whose widths are multiples of 128 (d_model 256, head_dim
128, d_ff 512, r = 16) is built by the reference, its adapters perturbed
with numpy (nonzero B, m off ||W||, nonzero QKV bias), and the same
weights are bridged into the port. The reference serves in interpret mode
(its Pallas kernels) and the port in fused mode, where every kernel
wrapper runs its plain version on the CPU tensors: K1/K2 in the
precompute, K6 in the 64-row prefill, K3 in the 2-row decode. Prefill
logits must agree within 1e-4 x max|logit| in fp32 and the greedy tokens
must be equal; a token that differs where the reference's top two logits
are within that tolerance is reported as a near-tie, not a fault.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import DoRAConfig as JConfig
from repro.launch import serve as jserve
from repro.launch.steps import StepConfig as JStep
from repro.launch.train import build_state
from repro.models import layers as jlayers
from repro.models.config import ModelConfig as JModel
from repro_torch.bridge import flatten_paths, tree_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.config import FORCE_TIER_ENV, DoRAConfig
from repro_torch.kernels import dora_compose, factored_norm, norm_assembly
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import StepConfig
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig
from test_torch_archs import assert_spec_matches_reference

WIDTHS = dict(name="slice-2l", family="dense", num_layers=2, d_model=256,
              num_heads=2, num_kv_heads=1, d_ff=512, vocab_size=512,
              qkv_bias=True, attn_chunk=16)
RANK, ALPHA = 16, 32.0
BATCH, PROMPT, GEN, MAX_LEN = 2, 20, 3, 32


@pytest.fixture(autouse=True)
def _no_forced_tier(monkeypatch):
    for name in ("REPRO_FORCE_TIER", "REPRO_DORA_MODE", "REPRO_DORA_FUSED",
                 FORCE_TIER_ENV):
        monkeypatch.delenv(name, raising=False)


def _perturbed_state(seed=0):
    """The reference's build_state, then nonzero B, m = ||W||·(1 + noise)
    and nonzero QKV biases, as numpy trees."""
    jm = JModel(**WIDTHS, dtype=jnp.float32)
    params, adapters, _ = build_state(jm, JConfig(rank=RANK, alpha=ALPHA),
                                      seed)
    params = jax.tree_util.tree_map(np.array, params)
    adapters = jax.tree_util.tree_map(np.array, adapters)
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
    return jm, params, adapters


def _compare_greedy(t_tok, j_tok, j_logits, rel) -> int:
    """Tokens equal, or the first difference sits on a near-tie of the
    reference's logits, which is reported and not a fault. Returns the
    number of generated steps over which the tokens agree."""
    diff = np.argwhere(t_tok != j_tok)
    if diff.size == 0:
        return t_tok.shape[1] - PROMPT
    b, pos = diff[0]
    step = pos - PROMPT
    row = np.sort(np.asarray(j_logits[step][b], np.float64))
    gap = row[-1] - row[-2]
    assert gap <= rel * np.abs(row).max(), (
        f"greedy token differs at batch {b}, position {pos} where the "
        f"reference's top-2 logit gap {gap} is not a near-tie")
    warnings.warn(f"greedy tokens differ on a near-tie at batch {b}, "
                  f"position {pos} (top-2 gap {gap})")
    return step


def test_slice_generate_matches_reference(monkeypatch):
    calls = {}
    for mod, name in ((factored_norm, "norm_terms_plain"),
                      (norm_assembly, "assemble_norm_plain"),
                      (dora_compose, "compose_fwd_plain"),
                      (dora_compose, "compose_mm_fwd_plain")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    jm, params, adapters = _perturbed_state()
    prompts = np.random.default_rng(1).integers(0, 512, (BATCH, PROMPT))
    j_tok, j_logits = jserve.generate(
        jm, params, adapters,
        JStep(dora=JConfig(rank=RANK, alpha=ALPHA, mode="interpret")),
        prompts, gen_len=GEN, max_len=MAX_LEN, return_logits=True)
    tm = ModelConfig(**WIDTHS, dtype=torch.float32)
    t_tok, t_logits = tserve.generate(
        tm, tree_from_numpy(params), tree_from_numpy(adapters),
        StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA, mode="fused")),
        prompts, gen_len=GEN, max_len=MAX_LEN, return_logits=True,
        device="cpu")

    n_adapted = 7 * WIDTHS["num_layers"]
    assert calls == {"norm_terms_plain": n_adapted,
                     "assemble_norm_plain": n_adapted,
                     "compose_mm_fwd_plain": n_adapted,
                     "compose_fwd_plain": n_adapted * GEN}
    rel = 1e-4
    got, want = t_logits[0].numpy(), np.asarray(j_logits[0])
    assert got.shape == want.shape == (BATCH, WIDTHS["vocab_size"])
    assert np.abs(got - want).max() <= rel * np.abs(want).max()
    agree = _compare_greedy(t_tok.numpy(), np.asarray(j_tok), j_logits, rel)
    for step in range(1, agree):   # decode logits, while the tokens agree
        got, want = t_logits[step].numpy(), np.asarray(j_logits[step])
        assert np.abs(got - want).max() <= rel * np.abs(want).max(), step


def test_generate_eager_matches_kernel_route():
    """Auto mode on CPU tensors is the eager route; it agrees with the
    forced kernel route's plain versions."""
    tm = ModelConfig(**WIDTHS, dtype=torch.float32)
    dcfg = DoRAConfig(rank=RANK, alpha=ALPHA)
    params, adapters = tserve.build_state(tm, dcfg, 2, "cpu")
    gen = torch.Generator().manual_seed(3)
    for layer in adapters["stack"]["l0"].values():
        for leaf in layer.values():
            leaf["B"] = 0.05 * torch.randn(leaf["B"].shape, generator=gen)
    prompts = np.random.default_rng(3).integers(0, 512, (BATCH, PROMPT))
    out = {}
    for mode in ("auto", "fused"):
        out[mode] = tserve.generate(
            tm, params, adapters,
            StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA, mode=mode)),
            prompts, gen_len=2, max_len=MAX_LEN, return_logits=True,
            device="cpu")
    (ta, la), (tf, lf) = out["auto"], out["fused"]
    torch.testing.assert_close(la[0], lf[0], rtol=0,
                               atol=1e-5 * la[0].abs().max().item())
    assert torch.equal(ta, tf)


def test_generate_without_device_raises_on_a_host_without_cuda():
    tm = get_config("qwen2-7b", smoke=True)
    dcfg = DoRAConfig(rank=4, alpha=8.0)
    params, adapters = tserve.build_state(tm, dcfg, 0, "cpu")
    with pytest.raises(RuntimeError, match="CUDA unavailable"):
        tserve.generate(tm, params, adapters, StepConfig(dora=dcfg),
                        np.zeros((1, 4), np.int64), gen_len=1, max_len=5)
    with pytest.raises(RuntimeError, match="CUDA unavailable"):
        tserve.resolve_device("cuda")
    toks = tserve.generate(tm, params, adapters, StepConfig(dora=dcfg),
                           np.zeros((1, 4), np.int64), gen_len=2, max_len=6,
                           device="cpu")
    assert toks.shape == (1, 6) and toks.dtype == torch.int64


def test_cli_serves_smoke_config_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "qwen2-7b", "--smoke", "--device", "cpu",
        "--batch", "2", "--prompt-len", "5", "--gen-len", "3"])
    tserve.main()
    out = capsys.readouterr().out
    assert "generated [2, 8] on cpu" in out and "tok/s" in out


def test_unported_archs_are_refused():
    """No registered arch is refused any more: jamba-v0.1-52b builds with
    its period of 8. An unknown arch is a KeyError. The period flags on a
    2-layer dense config build the reference's spec once the MoE flags
    name experts (a Mamba stack with attention every 8th layer has none
    at index 4 of 2 layers, and MoE every 4th layer none at index 3: both
    uniform, period 1; MoE every 2nd layer a unit of 2); without experts
    the port refuses them with the top_k ValueError."""
    jamba = get_config("jamba-v0.1-52b")
    assert jamba.period == 8 and jamba.n_scan == 4
    tlm.model_spec(jamba)
    with pytest.raises(KeyError):
        get_config("nope")
    experts = dict(num_experts=4, top_k=2)
    for flags, period in (({"moe": True, "moe_period": 4}, 1),
                          ({"ssm": True, "attn_period": 8}, 1),
                          ({"moe": True, "moe_period": 2}, 2)):
        if flags.get("moe"):
            with pytest.raises(ValueError, match="top_k"):
                tlm.model_spec(ModelConfig(**WIDTHS, **flags))
            flags = {**flags, **experts}
        mcfg, jm = ModelConfig(**WIDTHS, **flags), JModel(**WIDTHS, **flags)
        assert mcfg.period == jm.period == period
        assert_spec_matches_reference(mcfg, jm)


def test_full_config_matches_reference_widths():
    from repro.configs import get_config as jget
    t, j = get_config("qwen2-7b"), jget("qwen2-7b")
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "head_dim", "qkv_bias", "rope_theta",
              "attn_chunk", "norm_eps", "q_dim", "kv_dim"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.dtype == torch.bfloat16
    spec = tlm.model_spec(t)
    assert spec["stack"]["l0"]["ffn"]["w_gate"] == ("linear", (18944, 3584))
    paths = [p for p, _ in tlm._adapted_paths(t, tlm.DEFAULT_DORA_TARGETS)]
    assert len(paths) == 7
    shapes = tlm.cache_shapes(t, 4, 1024)
    assert shapes["stack"]["l0"]["k"][0] == (28, 4, 1024, 4, 128)


# --- layers ---------------------------------------------------------------

def _close(got, want, rel=1e-5):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 128)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    pos = np.arange(10, 15)[None].repeat(2, 0)
    tc, ts = tlayers.rope_cos_sin(torch.from_numpy(pos), 128, 1e6)
    jc, js = jlayers.rope_cos_sin(jnp.asarray(pos), 128, 1e6)
    _close(tc, jc, 1e-6)
    _close(ts, js, 1e-6)
    _close(tlayers.apply_rope(torch.from_numpy(x), tc, ts),
           jlayers.apply_rope(jnp.asarray(x), jc, js))
    # interleaved pairs, not rotate_half: the even/odd channels mix
    unit = torch.zeros(1, 1, 1, 4)
    unit[..., 0] = 1.0
    c, s = tlayers.rope_cos_sin(torch.tensor([[1]]), 4, 10000.0)
    out = tlayers.apply_rope(unit, c, s)
    assert out[..., 1].item() == pytest.approx(np.sin(1.0), rel=1e-6)


@pytest.mark.parametrize("s,t,offset,chunk", [(8, 40, 3, None),
                                              (7, 40, 3, 16)])
def test_attention_core_matches_reference(s, t, offset, chunk):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, s, 4, 128)).astype(np.float32)
    k = rng.standard_normal((2, t, 2, 128)).astype(np.float32)
    v = rng.standard_normal((2, t, 2, 128)).astype(np.float32)
    got = tlayers.attention_core(*map(torch.from_numpy, (q, k, v)),
                                 offset=offset, chunk=chunk)
    want = jlayers.attention_core(*map(jnp.asarray, (q, k, v)),
                                  offset=offset, chunk=chunk)
    _close(got, want)
    bias = tlayers._causal_mask_bias(s, t, offset, "cpu")
    np.testing.assert_array_equal(
        bias.numpy(), np.asarray(jlayers._causal_mask_bias(s, t, offset,
                                                           jnp.float32)))


def test_attention_writes_the_cache_in_place():
    tm = ModelConfig(**WIDTHS, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    params = tlm.init_params(gen, tm)
    cache = tlm.init_cache(tm, 1, 8)
    k_buf = cache["stack"]["l0"]["k"]
    x = torch.randn(1, 3, 256, generator=gen)
    p = {k: v[0] for k, v in params["stack"]["l0"]["mixer"].items()}
    _, new = tlayers.attention(
        x, p, None, tm, None, positions=torch.arange(3)[None],
        cache={"k": k_buf[0], "v": cache["stack"]["l0"]["v"][0], "len": 0},
        training=False)
    assert new["len"] == 3 and new["k"].data_ptr() == k_buf[0].data_ptr()
    assert k_buf[0, :, :3].abs().sum() > 0 and not k_buf[0, :, 3:].any()
