"""Serving step functions (counterpart of ``repro/launch/steps.py``):
precompute, padded prefill and decode.

Each builder returns a plain function over (params, adapters, ...). The
decode cache is updated IN PLACE: the K/V buffers the prefill allocates
are the ones every decode step writes, and the cache dict a step returns
holds those same buffers with "len" advanced.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.adapter import precompute_adapter_state
from repro_torch.core.config import DoRAConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import forward, init_cache


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Everything the step builders need beyond the model config."""
    dora: DoRAConfig = DoRAConfig(rank=384, alpha=192.0, mode="auto")


def make_precompute_step(mcfg: ModelConfig, scfg: StepConfig, *,
                         fold_gsb: bool = False):
    """(params, adapters) -> serving adapter tree: every adapter leaf gains
    a cached "g" (and "gsB" when folded), so prefill and decode do no norm
    work. The eps is the model dtype's, as the uncached forward uses."""

    def precompute_step(params, adapters):
        return precompute_adapter_state(params, adapters, scfg.dora,
                                        act_dtype=mcfg.dtype,
                                        fold_gsb=fold_gsb)

    return precompute_step


def make_prefill_step(mcfg: ModelConfig, scfg: StepConfig, *, batch: int,
                      seq: int, padded: bool = False):
    """(params, adapters, batch_in) -> (last_logits [B, V], cache).

    Runs the prompt and fills a fresh K/V cache of ``seq`` positions on
    the tokens' device. ``padded=True``: the prompt arrives right-padded
    to ``seq`` with the true length P in ``batch_in["prompt_len"]``; the
    logits are gathered at P-1 and the cache length is rewound to P, so
    the first decode token overwrites the first padded row (the padded
    rows beyond it are masked by causality)."""

    @torch.no_grad()
    def prefill_step(params, adapters, batch_in):
        tokens = batch_in["tokens"]
        if tuple(tokens.shape) != (batch, seq):
            raise ValueError(f"prefill built for tokens [{batch}, {seq}], "
                             f"got {tuple(tokens.shape)}")
        cache = init_cache(mcfg, batch, seq, device=tokens.device)
        kw = {}
        if padded:
            p_len = int(batch_in["prompt_len"])
            kw["gather_position"] = p_len - 1
        else:
            kw["loss_slice"] = 1
        logits, new_cache = forward(mcfg, params, adapters, scfg.dora,
                                    tokens=tokens, cache=cache,
                                    training=False, **kw)
        if padded:
            new_cache["len"] = p_len
        return logits[:, -1], new_cache

    return prefill_step


def make_decode_step(mcfg: ModelConfig, scfg: StepConfig, *, batch: int):
    """(params, adapters, cache, batch_in) -> (logits [B, V], cache'): one
    new token ``batch_in["tokens"]`` [B, 1] against the cache, written in
    place at position ``cache["len"]``."""

    @torch.no_grad()
    def decode_step(params, adapters, cache, batch_in):
        tokens = batch_in["tokens"]
        if tuple(tokens.shape) != (batch, 1):
            raise ValueError(f"decode built for tokens [{batch}, 1], got "
                             f"{tuple(tokens.shape)}")
        logits, new_cache = forward(mcfg, params, adapters, scfg.dora,
                                    tokens=tokens, cache=cache,
                                    training=False)
        return logits[:, -1], new_cache

    return decode_step
