"""Shared NN layers (counterpart of ``repro/models/layers.py``): RMSNorm,
RoPE, GQA attention with a rectangular KV cache, SwiGLU MLP, with DoRA
adaptation of every linear through ``maybe_dora``.

Weights follow the paper's [d_out, d_in] convention, y = x @ Wᵀ.
Attention is plain PyTorch that mirrors the reference's jnp code: every
contraction runs on fp32 operands (the reference's
``preferred_element_type=float32``) and the softmax statistics are fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.adapter import dora_linear
from repro_torch.core.config import DoRAConfig

_F32 = torch.float32


def linear(x, w, bias=None):
    y = x @ w.T
    if bias is not None:
        y = y + bias
    return y


def maybe_dora(x, w, dora: dict | None, cfg: DoRAConfig | None, *,
               bias=None, training: bool = True):
    """Adapted linear if a DoRA adapter is present, frozen linear
    otherwise."""
    if dora is None:
        return linear(x, w.detach(), bias)
    return dora_linear(x, w, dora, cfg, bias=bias, training=training)


def rms_norm(x, scale, eps: float = 1e-5):
    """Computed in fp32, cast back to x's dtype."""
    x32 = x.to(_F32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(_F32)).to(x.dtype)


def rope_cos_sin(positions, dim: int, theta: float):
    """positions [..., S] int → cos/sin [..., S, dim//2] fp32."""
    # theta stays a Python scalar: a device tensor made from it would be a
    # pageable host-to-device copy, which synchronises the stream.
    exponent = torch.arange(0, dim, 2, dtype=_F32,
                            device=positions.device) / dim
    freqs = 1.0 / torch.pow(theta, exponent)
    angles = positions.to(_F32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x [..., S, H, hd]; cos/sin [..., S, hd//2]. Rotates INTERLEAVED
    pairs (x[..., 0::2], x[..., 1::2]) as the reference does — not the
    half-split ``rotate_half`` layout."""
    x32 = x.to(_F32)
    x1 = x32[..., 0::2]
    x2 = x32[..., 1::2]
    c = cos[..., None, :]
    s = sin[..., None, :]
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def _causal_mask_bias(q_len: int, kv_len: int, offset: int, device):
    """Additive fp32 causal bias [q_len, kv_len]; ``offset`` is the
    absolute position of the first query row."""
    q_pos = offset + torch.arange(q_len, device=device)
    k_pos = torch.arange(kv_len, device=device)
    ok = k_pos[None, :] <= q_pos[:, None]
    return torch.where(ok, 0.0, -1e30).to(_F32)


def attention_core(q, k, v, *, offset: int = 0, chunk: int | None = None):
    """Grouped-query attention core. q: [B,S,Hq,hd]; k/v: [B,T,Hkv,hd].
    Queries are reshaped to [B,S,Hkv,group,hd] against the shared KV head.

    ``chunk``: online softmax over KV chunks, so the S×T score matrix is
    never materialized whole."""
    b, s, hq, hd = q.shape
    _, t, hkv, _ = k.shape
    group = hq // hkv
    qg = q.reshape(b, s, hkv, group, hd).to(_F32)
    scale = 1.0 / math.sqrt(hd)

    if chunk is None or t <= chunk:
        scores = torch.einsum("bskgh,btkh->bkgst", qg, k.to(_F32)) * scale
        scores = scores + _causal_mask_bias(s, t, offset, q.device)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgst,btkh->bskgh",
                           probs.to(q.dtype).to(_F32), v.to(_F32))
        return out.reshape(b, s, hq, hd).to(q.dtype)

    q_pos = offset + torch.arange(s, device=q.device)
    m = torch.full((b, hkv, group, s), -math.inf, dtype=_F32,
                   device=q.device)
    l_sum = torch.zeros((b, hkv, group, s), dtype=_F32, device=q.device)
    acc = torch.zeros((b, hkv, group, s, hd), dtype=_F32, device=q.device)
    for c0 in range(0, t, chunk):
        # The reference zero-pads K/V to whole chunks; its pad positions
        # carry the -1e30 bias and add exact zeros, so the last, shorter
        # chunk gives the same sums without the pad.
        kc = k[:, c0:c0 + chunk].to(_F32)
        vc = v[:, c0:c0 + chunk].to(_F32)
        k_pos = c0 + torch.arange(kc.shape[1], device=q.device)
        bias = torch.where(k_pos[None, :] <= q_pos[:, None], 0.0,
                           -1e30).to(_F32)
        sc = torch.einsum("bskgh,btkh->bkgst", qg, kc) * scale + bias
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l_sum = l_sum * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkh->bkgsh", p.to(q.dtype).to(_F32), vc)
        m = m_new
    out = acc / torch.clamp_min(l_sum, 1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, hd)
    return out.to(q.dtype)


def attention(x, params, dora, mcfg, dcfg: DoRAConfig | None, *,
              positions, cache=None, training: bool = True):
    """Attention block: QKV (DoRA-adapted), RoPE, core, O-proj.

    Returns (out, new_cache). ``cache`` = {"k", "v", "len"} with k/v
    [B, T, Hkv, hd] and a scalar int "len": the new K/V rows are written
    IN PLACE into the given buffers at position ``len`` (the reference
    returns updated copies), and attention runs over the whole buffer,
    whose unwritten rows causality masks."""
    b, s, _ = x.shape
    hq, hkv, hd = mcfg.num_heads, mcfg.num_kv_heads, mcfg.head_dim
    dora = dora or {}

    def proj(name):
        return maybe_dora(x, params[name], dora.get(name), dcfg,
                          bias=params.get(name + "_bias"), training=training)

    q = proj("wq").reshape(b, s, hq, hd)
    k = proj("wk").reshape(b, s, hkv, hd)
    v = proj("wv").reshape(b, s, hkv, hd)
    cos, sin = rope_cos_sin(positions, hd, mcfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is None:
        out = attention_core(q, k, v, offset=0, chunk=mcfg.attn_chunk)
        new_cache = None
    else:
        pos = int(cache["len"])
        ck, cv = cache["k"], cache["v"]
        if pos + s > ck.shape[1]:
            raise ValueError(f"KV cache of {ck.shape[1]} positions cannot "
                             f"take {s} more at position {pos}")
        ck[:, pos:pos + s] = k.to(ck.dtype)
        cv[:, pos:pos + s] = v.to(cv.dtype)
        # Decode (s == 1) attends densely over the cache: its score matrix
        # is [B, Hq, 1, T], and chunking would only add steps.
        out = attention_core(q, ck, cv, offset=pos,
                             chunk=None if s == 1 else mcfg.attn_chunk)
        new_cache = {"k": ck, "v": cv, "len": pos + s}

    out = out.reshape(b, s, hq * hd)
    y = maybe_dora(out, params["wo"], dora.get("wo"), dcfg,
                   training=training)
    return y, new_cache


def mlp_swiglu(x, params, dora, dcfg: DoRAConfig | None, *,
               training: bool = True):
    d = dora or {}
    gate = maybe_dora(x, params["w_gate"], d.get("w_gate"), dcfg,
                      training=training)
    up = maybe_dora(x, params["w_up"], d.get("w_up"), dcfg,
                    training=training)
    return maybe_dora(F.silu(gate) * up, params["w_down"], d.get("w_down"),
                      dcfg, training=training)
