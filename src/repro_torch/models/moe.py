"""Mixture-of-experts FFN (counterpart of ``repro/models/moe.py``): shared
experts + routed top-k with capacity.

Tokens stay grouped by batch row (or by sequence chunk, with
``moe_seq_chunks``): each group routes its N tokens' k assignments into a
capacity buffer of C slots an expert, C = max(int(cf·k·N/E), 1). An
assignment's slot is its position among the group's assignments to the
same expert (a one-hot cumsum); one at position >= C is dropped and adds
nothing (GShard). Expert weights are stacked [E, ...] and run as one
batched product per projection over the expert dim.

The buffer is expert-major, [E, G·C, D], so the batched products read it
as it lies. Every slot receives at most one kept assignment, so the
dispatch is a plain indexed write of the kept rows (dropped ones go to
one extra row that is cut off), with no accumulation. The combine gathers
each assignment's expert output back, as the reference does (a dropped
pick reads its clamped slot and is weighted by zero), and runs in the
activation dtype.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.adapter import dora_linear_stacked
from repro_torch.core.config import DoRAConfig
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

_F32 = torch.float32


def router_topk(x, w_router, cfg: ModelConfig):
    """x [G, S, D] → (weights [G, S, k] fp32, idx [G, S, k] int64, aux).

    fp32 logits and softmax, then ``torch.topk(sorted=True)``: the k
    largest probabilities in descending order. On an exact tie
    ``jax.lax.top_k`` takes the lower expert index first, while torch
    leaves the order of equal values unspecified; routers with random or
    trained weights give no exact ties, and the parity tests assert a
    margin between neighbouring top probabilities. ``aux`` is the
    Switch load-balance loss E·Σ f_e·p_e times ``router_aux_coef`` (fp32
    0-d; zero when the coefficient is 0)."""
    logits = x.to(_F32) @ w_router.to(_F32).T                  # [G, S, E]
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_i = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    if cfg.renorm_topk:
        gate_w = gate_w / torch.clamp_min(
            gate_w.sum(dim=-1, keepdim=True), 1e-9)
    aux = torch.zeros((), dtype=_F32, device=x.device)
    if cfg.router_aux_coef:
        E = cfg.num_experts
        me = probs.reshape(-1, E).mean(dim=0)
        ce = F.one_hot(gate_i.reshape(-1, cfg.top_k), E).to(_F32).sum(
            dim=1).mean(dim=0) / cfg.top_k
        aux = cfg.router_aux_coef * E * (me * ce).sum()
    return gate_w, gate_i, aux


def _dispatch_indices(gate_i, E: int, capacity: int):
    """Each (token, k) assignment's place in its expert's capacity buffer,
    from a cumsum over the group's flattened assignments.

    gate_i [G, N, k] → (slot [G, N, k] into [E·C], keep [G, N, k] bool):
    slot = expert·C + min(position, C − 1), keep = position < C. The
    one-hot is laid out [G, E, N·k], so the cumsum runs along the
    innermost dim (int32: exact)."""
    G, N, k = gate_i.shape
    flat = gate_i.reshape(G, N * k)
    experts = torch.arange(E, device=flat.device, dtype=flat.dtype)
    onehot = (flat[:, None, :] == experts[:, None]).to(torch.int32)
    pos = onehot.cumsum(dim=2, dtype=torch.int32) - 1          # per expert
    pos = torch.gather(pos, 1, flat[:, None, :])[:, 0]         # [G, N·k]
    keep = pos < capacity
    slot = flat * capacity + torch.clamp_max(pos, capacity - 1)
    return slot.reshape(G, N, k), keep.reshape(G, N, k)


def _expert_ffn(buf, p, dora, dcfg: DoRAConfig | None, mcfg: ModelConfig,
                *, training: bool):
    """buf [E, N, D] → [E, N, D] through the stacked experts (gate/up
    [E, F, D], down [E, D, F]): one batched product per projection, or,
    for a projection with a stacked DoRA adapter in ``dora``,
    :func:`~repro_torch.core.adapter.dora_linear_stacked`."""
    act = F.silu if mcfg.mlp_kind == "swiglu" else (
        lambda t: F.gelu(t, approximate="tanh"))
    dora = dora or {}

    def proj(x, name):
        if dora.get(name) is None:
            return torch.bmm(x, p[name].detach().transpose(1, 2))
        return dora_linear_stacked(x, p[name], dora[name], dcfg,
                                   training=training)

    h = act(proj(buf, "gate")) * proj(buf, "up")
    return proj(h, "down")


def _dispatch(x, slot, keep, E: int, capacity: int):
    """Write each kept assignment's token into the expert-major capacity
    buffer. Expert e's slot c of group g is row e·G·C + g·C + c; every
    such row receives at most one kept token, so a plain indexed write
    does it, and dropped assignments write one extra row that is cut off.

    x [G, S, D], slot/keep [G, S, k] → (buf [E, G·C, D], src [G, S, k]
    each assignment's row, clamped as the reference's slot is)."""
    G, _, D = x.shape
    C = capacity
    group = torch.arange(G, device=x.device).view(G, 1, 1)
    src = (slot // C * G + group) * C + slot % C
    dst = torch.where(keep, src, E * G * C)
    buf = x.new_zeros((E * G * C + 1, D)).index_put((dst,), x[:, :, None])
    return buf[:-1].view(E, G * C, D), src


def _combine(out, src, keep, gate_w):
    """Gather each assignment's expert output [E, G·C, D] back to its
    token and weight it by its gate (zero for a dropped one), in the
    activation dtype: y [G, S, D]."""
    G, S, k = src.shape
    D = out.shape[-1]
    picked = out.reshape(-1, D)[src.reshape(-1)].view(G, S, k, D)
    w = torch.where(keep, gate_w, 0.0).to(out.dtype)
    return torch.einsum("gskd,gsk->gsd", picked, w)


def moe_ffn(x, p, dora, mcfg: ModelConfig, dcfg: DoRAConfig | None, *,
            training: bool = True):
    """x [B, S, D] → (y [B, S, D], aux fp32 0-d).

    p: {"router": [E, D], "gate"/"up": [E, F, D], "down": [E, D, F],
    optional "shared": swiglu params, "shared_gate": [1, D]}.
    dora: {"shared": {...}, "experts": {...}} or None.

    ``mcfg.moe_seq_chunks = nc > 1`` with S divisible by nc folds the
    sequence into B·nc groups, each with its own capacity cf·k·(S/nc)/E.
    The router and shared-gate weights get no gradient; the gate weights
    stay differentiable with respect to x."""
    nc = mcfg.moe_seq_chunks
    if nc > 1 and x.shape[1] % nc == 0 and x.shape[1] // nc > 0:
        B0, S0, D0 = x.shape
        y, aux = moe_ffn(x.reshape(B0 * nc, S0 // nc, D0), p, dora,
                         dataclasses.replace(mcfg, moe_seq_chunks=0), dcfg,
                         training=training)
        return y.reshape(B0, S0, D0), aux

    S = x.shape[1]
    E, k = mcfg.num_experts, mcfg.top_k
    dora = dora or {}
    gate_w, gate_i, aux = router_topk(x, p["router"].detach(), mcfg)
    C = max(int(mcfg.capacity_factor * k * S / E), 1)
    slot, keep = _dispatch_indices(gate_i, E, C)               # [G, S, k]
    buf, src = _dispatch(x, slot, keep, E, C)
    out = _expert_ffn(buf, p, dora.get("experts"), dcfg, mcfg,
                      training=training)
    y = _combine(out, src, keep, gate_w)

    if mcfg.num_shared_experts:
        sh = L.mlp_swiglu(x, p["shared"], dora.get("shared"), dcfg,
                          training=training)
        if "shared_gate" in p:
            sg = torch.sigmoid(x.to(_F32)
                               @ p["shared_gate"].detach().to(_F32).T)
            sh = sh.to(_F32) * sg                              # [G, S, 1]
        y = y + sh.to(_F32)
    return y.to(x.dtype), aux
