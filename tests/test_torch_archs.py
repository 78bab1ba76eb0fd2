"""The rest of the dense family against the reference: partial RoPE,
M-RoPE, sinusoidal positions, qk-norm, LayerNorm and the GELU MLP, and the
six archs that use them (phi4-mini-3.8b, qwen2-vl-7b, chatglm3-6b,
qwen3-32b, musicgen-medium, qwen2-vl-72b).

Inputs come from numpy and a seed. Function-level results must be within
1e-6 of the largest magnitude of the reference's output. Per arch, the
SMOKE config's params and adapters are built by the reference, perturbed
with numpy (nonzero B, m off ||W||, and every bias, norm scale, LayerNorm
bias and q/k-norm scale off its init, so each leaf carries signal) and
bridged into the port, where both packages run their eager routes on the
CPU: prefill logits within 1e-5 of max, adapter gradients within 1e-4 of
max, and 4 equal greedy tokens (``test_torch_archs_embeds.py`` does the
same from a frontend's embeddings).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jget_config
from repro.core.config import DoRAConfig as JConfig
from repro.launch import serve as jserve
from repro.launch.steps import StepConfig as JStep
from repro.launch.steps import cross_entropy as jcross_entropy
from repro.launch.train import build_state as jbuild_state
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.bridge import flatten_paths, tree_from_numpy, tree_to_numpy
from repro_torch.configs import NOT_PORTED, get_config
from repro_torch.core.config import FORCE_TIER_ENV, DoRAConfig
from repro_torch.kernels import _build
from repro_torch.kernels import dora_compose as tk_compose
from repro_torch.kernels import factored_norm as tk_norm
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import StepConfig, make_grad_step
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm

ARCHS = ["phi4-mini-3.8b", "qwen2-vl-7b", "chatglm3-6b", "qwen3-32b",
         "musicgen-medium", "qwen2-vl-72b"]
RANK, ALPHA = 8, 16.0
BATCH, PROMPT, GEN, SEQ = 2, 12, 4, 16


@pytest.fixture(autouse=True)
def _no_forced_tier(monkeypatch):
    for name in ("REPRO_FORCE_TIER", "REPRO_DORA_MODE", "REPRO_DORA_FUSED",
                 FORCE_TIER_ENV):
        monkeypatch.delenv(name, raising=False)


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    if isinstance(got, torch.Tensor):
        got = got.detach().double().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


# --- the layers -------------------------------------------------------------

def test_apply_rope_partial_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 5))
    tc, ts = tlayers.rope_cos_sin(torch.from_numpy(pos), 16, 1e4)
    jc, js = jlayers.rope_cos_sin(jnp.asarray(pos), 16, 1e4)
    got = tlayers.apply_rope_partial(torch.from_numpy(x), tc, ts, 16)
    assert _rel(got, jlayers.apply_rope_partial(jnp.asarray(x), jc, js,
                                                16)) <= 1e-6
    # the channels past rotary_dim pass through untouched
    assert torch.equal(got[..., 16:], torch.from_numpy(x)[..., 16:])


def test_mrope_cos_sin_matches_reference_on_distinct_streams():
    """Three different (t, h, w) streams, so each section's angles come
    from its own stream; equal streams give standard RoPE."""
    rng = np.random.default_rng(1)
    pos3 = np.stack([rng.integers(0, 4096, (2, 7)) for _ in range(3)])
    sections = (2, 3, 3)
    tc, ts = tlayers.mrope_cos_sin(torch.from_numpy(pos3), 16, 1e6,
                                   sections)
    jc, js = jlayers.mrope_cos_sin(jnp.asarray(pos3), 16, 1e6, sections)
    assert _rel(tc, jc) <= 1e-6 and _rel(ts, js) <= 1e-6
    rc, _ = tlayers.rope_cos_sin(torch.from_numpy(pos3[1]), 16, 1e6)
    assert torch.equal(tc[..., 2:5], rc[..., 2:5])
    assert not torch.equal(tc[..., :2], rc[..., :2])
    same = torch.from_numpy(np.stack([pos3[0]] * 3))
    assert torch.equal(tlayers.mrope_cos_sin(same, 16, 1e6, sections)[0],
                       tlayers.rope_cos_sin(same[0], 16, 1e6)[0])
    with pytest.raises(AssertionError):
        tlayers.mrope_cos_sin(torch.from_numpy(pos3), 16, 1e6, (2, 3, 4))


def test_sinusoidal_embedding_matches_reference():
    """Within 1e-6 of max at the positions of a short prompt. Far out, a
    frequency one fp32 ulp off moves the angle by position x ulp: XLA's
    CPU exp misses the correctly rounded value of 6 of the 32 frequencies
    and torch's of 1, so at positions near 3000 the two packages end
    7e-6 apart, and there the port is held to the float64 embedding no
    less closely than the reference is."""
    pos = np.arange(0, 256, 7)[None].repeat(2, 0)
    got = tlayers.sinusoidal_embedding(torch.from_numpy(pos), 64)
    want = jlayers.sinusoidal_embedding(jnp.asarray(pos), 64)
    assert got.dtype == torch.float32 and _rel(got, want) <= 1e-6
    # concat([cos, sin]), not interleaved
    assert torch.equal(got[..., 0, :32], torch.ones(2, 32))
    far = np.arange(0, 3000, 97)
    half = 32
    exact = far[:, None] * np.exp(-np.log(1e4) * np.arange(half) / half)
    exact = np.concatenate([np.cos(exact), np.sin(exact)], axis=-1)
    err_port = _rel(tlayers.sinusoidal_embedding(torch.from_numpy(far), 64),
                    exact)
    err_ref = _rel(jlayers.sinusoidal_embedding(jnp.asarray(far), 64), exact)
    assert err_port <= max(err_ref, 1e-6), (err_port, err_ref)


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(2)
    x = (3.0 + rng.standard_normal((2, 5, 64))).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(64)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(64)).astype(np.float32)}
    tm = get_config("musicgen-medium", smoke=True)
    got = tlm._apply_norm(torch.from_numpy(x), tree_from_numpy(p), tm)
    want = jlm._apply_norm(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, p), jget_config("musicgen-medium", smoke=True))
    assert _rel(got, want) <= 1e-6


def test_tanh_gelu_matches_reference():
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    got = F.gelu(torch.from_numpy(x), approximate="tanh")
    want = jax.nn.gelu(jnp.asarray(x))
    assert _rel(got, want) <= 1e-6
    # the erf form is not the reference's: 80x the tolerance away
    assert _rel(F.gelu(torch.from_numpy(x)), want) > 5e-5


# --- configs ----------------------------------------------------------------

def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else jnp.dtype(dt).name


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, smoke):
    t, j = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    shared = [f.name for f in dataclasses.fields(t)
              if f.name in {g.name for g in dataclasses.fields(j)}]
    assert len(shared) == len(dataclasses.fields(t))
    for f in shared:
        if f == "dtype":
            assert _dtype_name(t.dtype) == _dtype_name(j.dtype)
        else:
            assert getattr(t, f) == getattr(j, f), f
    for prop in ("q_dim", "kv_dim", "period"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.n_scan == j.num_layers // j.period
    assert t.layer_kinds() == j.layer_kinds()
    assert t.ffn_kinds() == j.ffn_kinds()
    tlm.model_spec(t)


def assert_spec_matches_reference(tm, jm):
    """The port's parameter spec equals the reference's, leaf by leaf
    under its "/"-joined path."""
    got = {"/".join(p): leaf
           for p, leaf in tlm._spec_items(tlm.model_spec(tm))}
    want = {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                jlm.model_spec(jm), is_leaf=jlm._is_leaf_spec)[0]}
    assert got == want


@pytest.mark.parametrize("arch", ["qwen2-7b", "falcon-mamba-7b", *ARCHS,
                                  "qwen2-moe-a2.7b", "llama4-scout-17b-a16e",
                                  "jamba-v0.1-52b"])
def test_shapes_match_reference(arch):
    """``configs/shapes.py``: the assigned shape sets, field by field, and
    which of them each arch runs (full and SMOKE configs)."""
    from repro.configs import shapes as jshapes
    from repro_torch.configs import shapes as tshapes

    for table in ("SHAPES", "SMOKE_SHAPES"):
        t, j = getattr(tshapes, table), getattr(jshapes, table)
        assert {k: dataclasses.astuple(v) for k, v in t.items()} == {
            k: dataclasses.astuple(v) for k, v in j.items()}, table
    for smoke in (False, True):
        assert tshapes.applicable_shapes(get_config(arch, smoke=smoke)) == \
            jshapes.applicable_shapes(jget_config(arch, smoke=smoke))


def test_registry_ports_every_dense_arch():
    """Every arch the reference registers is ported (``NOT_PORTED`` is
    empty): the dense ones and the hybrid jamba-v0.1-52b, whose FULL and
    SMOKE configs build with the reference's period of 8; an unknown
    name is a KeyError."""
    from repro.configs import _MODULES as jmodules
    from repro_torch.configs import _MODULES as tmodules
    assert NOT_PORTED == ()
    assert set(tmodules) == set(jmodules)
    for arch in (*ARCHS, "jamba-v0.1-52b"):
        assert get_config(arch).name == arch
    for smoke in (False, True):
        assert get_config("jamba-v0.1-52b", smoke=smoke).period == \
            jget_config("jamba-v0.1-52b", smoke=smoke).period == 8
    with pytest.raises(KeyError):
        get_config("nope")


def test_shapes_of_the_new_features():
    """qwen3-32b's decoupled head_dim, musicgen's gelu MLP with its 6
    adapted modules, LayerNorm biases, q/k-norm scales."""
    q3 = get_config("qwen3-32b")
    spec = tlm.model_spec(q3)["stack"]["l0"]
    assert spec["mixer"]["wq"] == ("linear", (8192, 5120))
    assert spec["mixer"]["wo"] == ("linear", (5120, 8192))
    assert spec["mixer"]["q_norm"] == ("ones", (128,))
    assert tlm.cache_shapes(q3, 4, 1024)["stack"]["l0"]["k"][0] == \
        (64, 4, 1024, 8, 128)
    mg = get_config("musicgen-medium")
    spec = tlm.model_spec(mg)
    assert spec["final_norm"] == {"scale": ("ones", (1536,)),
                                  "bias": ("zeros", (1536,))}
    assert set(spec["stack"]["l0"]["ffn"]) == {"w_up", "w_up_bias", "w_down",
                                               "w_down_bias"}
    paths = [p[-1] for p, _ in tlm._adapted_paths(mg,
                                                  tlm.DEFAULT_DORA_TARGETS)]
    assert sorted(paths) == ["w_down", "w_up", "wk", "wo", "wq", "wv"]


def test_bad_values_are_refused():
    base = get_config("qwen2-7b", smoke=True)
    for kw in ({"pos_mode": "alibi"}, {"mlp_kind": "geglu"},
               {"norm_kind": "batch"}, {"frontend": "video"},
               {"pos_mode": "rope_partial", "rotary_dim": 0},
               {"pos_mode": "rope_partial", "rotary_dim": 7},
               {"pos_mode": "mrope", "mrope_sections": (2, 3, 4)}):
        with pytest.raises(ValueError):
            tlm.model_spec(dataclasses.replace(base, **kw))
    mcfg = get_config("qwen2-vl-7b", smoke=True)
    params, _ = tserve.build_state(mcfg, DoRAConfig(rank=4), 0, "cpu")
    with pytest.raises(ValueError, match="exactly one"):
        tlm.forward(mcfg, params, None, None, training=False)
    with pytest.raises(ValueError, match="exactly one"):
        tlm.forward(mcfg, params, None, None, tokens=torch.zeros(1, 2).long(),
                    embeds=torch.zeros(1, 2, 64), training=False)


# --- the archs against the reference ---------------------------------------

def perturbed_state(arch, seed=0, dtype=None, layers=None):
    """The reference's SMOKE build_state with nonzero B, m = ||W||·(1 +
    noise), and every bias, norm scale and norm bias off its init, as
    numpy trees; with the reference's and the port's configs (``layers``:
    the SMOKE config at that depth in both packages)."""
    jm = jget_config(arch, smoke=True)
    if dtype is not None:
        jm = dataclasses.replace(jm, dtype=dtype)
    if layers is not None:
        jm = dataclasses.replace(jm, num_layers=layers)
    params, adapters, _ = jbuild_state(jm, JConfig(rank=RANK, alpha=ALPHA),
                                       seed)
    params = jax.tree_util.tree_map(np.array, params)
    adapters = jax.tree_util.tree_map(np.array, adapters)
    rng = np.random.default_rng(seed)

    def noise(leaf, scale):
        return (scale * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    for name, leaf in flatten_paths(adapters).items():
        if name.endswith("/B"):
            leaf[...] = noise(leaf, 0.05)
        elif name.endswith("/m"):
            leaf *= 1 + noise(leaf, 0.01)
    for name, leaf in flatten_paths(params).items():
        if name.endswith(("_bias", "/bias")):
            leaf[...] = noise(leaf, 0.1)
        elif name.endswith(("/scale", "q_norm", "k_norm")):
            leaf[...] = 1 + noise(leaf, 0.1)
    tm = get_config(arch, smoke=True)
    if dtype is not None:
        tm = dataclasses.replace(tm, dtype=torch.bfloat16)
    if layers is not None:
        tm = dataclasses.replace(tm, num_layers=layers)
    return jm, tm, params, adapters


def reference_grads(jm, params, adapters, inputs, labels):
    """jax.grad of the token-mean NLL over the reference's training
    forward, with respect to the adapters."""
    dcfg = JConfig(rank=RANK, alpha=ALPHA, mode="eager")

    def loss(a):
        logits, _, aux = jlm.forward(jm, params, a, dcfg, training=True,
                                     **inputs)
        return jcross_entropy(logits, labels) + aux
    return jax.tree_util.tree_map(np.asarray, jax.grad(loss)(adapters))


def port_grads(tm, params, adapters, batch_in):
    step = make_grad_step(tm, StepConfig(dora=DoRAConfig(rank=RANK,
                                                         alpha=ALPHA)),
                          batch=BATCH, seq=SEQ)
    _, grads = step(tree_from_numpy(params), tree_from_numpy(adapters),
                    batch_in)
    return tree_to_numpy(grads)


def assert_grads_close(got, want):
    got, want = flatten_paths(got), flatten_paths(want)
    assert set(got) == set(want)
    for name in want:
        if not name.endswith("base_sq"):
            assert _rel(got[name], want[name]) <= 1e-4, name


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch):
    """Prefill logits within 1e-5 of max and 4 equal greedy tokens, the
    decode logits too while they agree."""
    jm, tm, params, adapters = perturbed_state(arch)
    prompts = np.random.default_rng(1).integers(0, jm.vocab_size,
                                                (BATCH, PROMPT))
    j_tok, j_logits = jserve.generate(
        jm, params, adapters,
        JStep(dora=JConfig(rank=RANK, alpha=ALPHA, mode="eager")), prompts,
        gen_len=GEN, max_len=SEQ, return_logits=True)
    t_tok, t_logits = tserve.generate(
        tm, tree_from_numpy(params), tree_from_numpy(adapters),
        StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA)), prompts,
        gen_len=GEN, max_len=SEQ, return_logits=True, device="cpu")
    for step in range(GEN):
        assert _rel(t_logits[step], j_logits[step]) <= 1e-5, step
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))


@pytest.mark.parametrize("arch", ARCHS)
def test_adapter_grads_match_reference(arch):
    jm, tm, params, adapters = perturbed_state(arch)
    toks = np.random.default_rng(2).integers(
        0, jm.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    want = reference_grads(jm, params, adapters,
                           {"tokens": jnp.asarray(toks[:, :-1])},
                           jnp.asarray(toks[:, 1:]))
    got = port_grads(tm, params, adapters,
                     {"tokens": torch.from_numpy(toks[:, :-1]).long(),
                      "labels": torch.from_numpy(toks[:, 1:]).long()})
    assert_grads_close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_the_new_leaves_both_ways(arch):
    """A bf16 reference param tree (q/k-norm scales, LayerNorm biases, the
    gelu MLP's biases) crosses the bridge bit for bit both ways, and the
    port's stacked-leaf slicing gives each layer its own slice."""
    _, tm, params, adapters = perturbed_state(arch, dtype=jnp.bfloat16)
    tp, ta = tree_from_numpy(params), tree_from_numpy(adapters)
    assert tp["embed"].dtype == torch.bfloat16
    spec_paths = {"/".join(p) for p, _ in tlm._spec_items(tlm.model_spec(tm))}
    assert set(flatten_paths(tp)) == spec_paths
    for name, leaf in flatten_paths(tree_to_numpy(tp)).items():
        want = flatten_paths(params)[name]
        assert leaf.dtype == want.dtype
        np.testing.assert_array_equal(leaf.view(np.uint16),
                                      want.view(np.uint16))
    units = tlm._unstack_tree(ta["stack"], tm.n_scan)
    for i in range(tm.n_scan):
        layer = tlm._slice_tree(tp["stack"], i)
        for name, leaf in flatten_paths(layer).items():
            assert torch.equal(leaf, flatten_paths(tp["stack"])[name][i])
        for name, leaf in flatten_paths(units[i]).items():
            assert torch.equal(leaf, flatten_paths(ta["stack"])[name][i])


# --- the kernels' plans at the new archs' shapes -----------------------------

NEW_K1 = [(3072, 8192), (8192, 3072), (1024, 3072), (4096, 13696),
          (13696, 4096), (256, 4096), (5120, 25600), (25600, 5120),
          (5120, 8192), (8192, 5120), (1536, 6144), (6144, 1536),
          (8192, 29568), (29568, 8192)]


@pytest.mark.parametrize("d_out,d_in", NEW_K1)
def test_norm_terms_split_covers_the_new_shapes(d_out, d_in):
    """K1's d_in split at the new archs' weights: whole k-tiles that cover
    d_in exactly once and put a block on every SM where the axis allows
    (d_in 13696, 25600 and 29568 are no multiple of the split length)."""
    r = 384
    splits, split_k = tk_norm.norm_terms_split(d_out, d_in, r)
    tiles = (_build.cdiv(d_out, tk_norm.TILE_ROWS)
             * _build.cdiv(r, tk_norm.TILE_RANK))
    assert split_k % tk_norm.TILE_K == 0
    assert (splits - 1) * split_k < d_in <= splits * split_k
    assert tiles * splits >= _build.SMS or split_k == tk_norm.TILE_K


@pytest.mark.parametrize("n", [3072, 8192, 13696, 5120, 25600, 6144, 29568])
def test_compose_mm_plans_cover_the_new_shapes(n):
    """K6's persistent schedule writes each [128 x 192] tile of a 4096-row
    prefill once (N 13696, 25600, 8192 end in a partial column tile), and
    K7's N split covers N once at the training rows."""
    m, r = 4096, 384
    rows = _build.cdiv(m, tk_compose.MM_FWD_TILE_ROWS)
    cols = _build.cdiv(n, tk_compose.MM_FWD_TILE_COLS)
    blocks = tk_compose.compose_mm_fwd_blocks(m, n)
    assert blocks == _build.SMS
    seen = np.zeros(rows * cols, np.int64)
    for b in range(blocks):
        seen[b::blocks] += 1
    assert (seen == 1).all()
    splits, split_n = tk_compose.compose_mm_bwd_split(m, n, r)
    assert split_n % tk_compose.MM_BWD_TILE_K == 0
    assert (splits - 1) * split_n < n <= splits * split_n


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_each_new_arch_on_cpu(arch, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", arch, "--smoke", "--device", "cpu",
        "--batch", "2", "--prompt-len", "5", "--gen-len", "3"])
    tserve.main()
    assert "generated [2, 8] on cpu" in capsys.readouterr().out
