"""qwen2-vl-7b and musicgen-medium from a frontend's embeddings against
the reference.

Their frontends are stubs in both packages: the batch carries
precomputed patch (qwen2-vl) or frame (musicgen) embeddings [B, S,
d_model] in place of token ids, and the steps take {"embeds", ...}. The
SMOKE params and adapters are the reference's, perturbed as in
``test_torch_archs.py`` and bridged into the port; the embeddings are
drawn with numpy. Held: the unpadded prefill's logits within 1e-5 of
max, 4 equal greedy tokens decoded after it (each fed back as a token),
and the adapter gradients of the loss from embeddings within 1e-4 of max.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import DoRAConfig as JConfig
from repro.launch import steps as jsteps
from repro_torch.bridge import tree_from_numpy
from repro_torch.core.config import FORCE_TIER_ENV, DoRAConfig
from repro_torch.launch import steps as tsteps
from test_torch_archs import (ALPHA, BATCH, GEN, PROMPT, RANK, SEQ, _rel,
                              assert_grads_close, perturbed_state,
                              port_grads, reference_grads)

ARCHS = ["qwen2-vl-7b", "musicgen-medium"]


@pytest.fixture(autouse=True)
def _no_forced_tier(monkeypatch):
    for name in ("REPRO_FORCE_TIER", "REPRO_DORA_MODE", "REPRO_DORA_FUSED",
                 FORCE_TIER_ENV):
        monkeypatch.delenv(name, raising=False)


def _embeds(jm, shape, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        shape + (jm.d_model,))).astype(np.float32)


def _reference_stream(jm, params, adapters, embeds):
    scfg = jsteps.StepConfig(dora=JConfig(rank=RANK, alpha=ALPHA,
                                          mode="eager"))
    state = jax.jit(jsteps.make_precompute_step(jm, scfg))(params, adapters)
    prefill = jax.jit(jsteps.make_prefill_step(jm, scfg, batch=BATCH,
                                               seq=SEQ))
    decode = jax.jit(jsteps.make_decode_step(jm, scfg, batch=BATCH))
    logits, cache = prefill(params, state, {"embeds": jnp.asarray(embeds)})
    first, toks = np.asarray(logits), []
    for _ in range(GEN):
        nxt = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(nxt))
        logits, cache = decode(params, state, cache, {"tokens": nxt})
    return first, np.concatenate(toks, axis=1)


def _port_stream(tm, params, adapters, embeds):
    scfg = tsteps.StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA))
    state = tsteps.make_precompute_step(tm, scfg)(params, adapters)
    prefill = tsteps.make_prefill_step(tm, scfg, batch=BATCH, seq=SEQ)
    decode = tsteps.make_decode_step(tm, scfg, batch=BATCH)
    logits, cache = prefill(params, state,
                            {"embeds": torch.from_numpy(embeds)})
    assert cache["len"] == embeds.shape[1]
    first, toks = logits.numpy(), []
    for _ in range(GEN):
        nxt = torch.argmax(logits, dim=-1)[:, None]
        toks.append(nxt.numpy())
        logits, cache = decode(params, state, cache, {"tokens": nxt})
    return first, np.concatenate(toks, axis=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_from_embeds_matches_reference(arch):
    jm, tm, params, adapters = perturbed_state(arch)
    embeds = _embeds(jm, (BATCH, PROMPT), 3)
    j_first, j_toks = _reference_stream(jm, params, adapters, embeds)
    t_first, t_toks = _port_stream(tm, tree_from_numpy(params),
                                   tree_from_numpy(adapters), embeds)
    assert _rel(t_first, j_first) <= 1e-5
    np.testing.assert_array_equal(t_toks, j_toks)


@pytest.mark.parametrize("arch", ARCHS)
def test_adapter_grads_from_embeds_match_reference(arch):
    jm, tm, params, adapters = perturbed_state(arch)
    embeds = _embeds(jm, (BATCH, SEQ), 4)
    labels = np.random.default_rng(5).integers(
        0, jm.vocab_size, (BATCH, SEQ)).astype(np.int32)
    want = reference_grads(jm, params, adapters,
                           {"embeds": jnp.asarray(embeds)},
                           jnp.asarray(labels))
    got = port_grads(tm, params, adapters,
                     {"embeds": torch.from_numpy(embeds),
                      "labels": torch.from_numpy(labels).long()})
    assert_grads_close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_embeds_of_the_tokens_give_the_tokens_logits(arch):
    """The embeddings path is the token path with the table lookup done
    by the caller: the same logits and cache, bit for bit."""
    _, tm, params, adapters = perturbed_state(arch)
    params, adapters = tree_from_numpy(params), tree_from_numpy(adapters)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, tm.vocab_size, (BATCH, PROMPT)))
    scfg = tsteps.StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA))
    prefill = tsteps.make_prefill_step(tm, scfg, batch=BATCH, seq=SEQ)
    by_tok = prefill(params, adapters, {"tokens": toks})
    by_emb = prefill(params, adapters, {"embeds": params["embed"][toks]})
    assert torch.equal(by_tok[0], by_emb[0])
    assert torch.equal(by_tok[1]["stack"]["l0"]["k"],
                       by_emb[1]["stack"]["l0"]["k"])
    with pytest.raises(ValueError, match="embeds"):
        prefill(params, adapters, {"embeds": params["embed"][toks][:, :, :8]
                                   .reshape(BATCH, -1)})
