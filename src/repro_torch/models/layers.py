"""Shared NN layers (counterpart of ``repro/models/layers.py``): RMSNorm,
RoPE (standard, partial, M-RoPE) and sinusoidal positions, GQA attention
(qk-norm, QKV bias) with a rectangular or block-paged KV cache, SwiGLU
MLP, with DoRA adaptation of every linear through ``maybe_dora``.

Under a mesh (``sp``, the sequence-parallel layout of
``core/sharding.py``) each block takes this rank's [B, S/tp, D] rows,
all-gathers them before its column-parallel projections (wq, wk, wv,
w_gate, w_up: local rows of W), runs attention on its local heads, and
its row-parallel projection (wo, w_down: local columns of W)
reduce-scatters back to [B, S/tp, D].

Weights follow the paper's [d_out, d_in] convention, y = x @ Wᵀ.
Attention is plain PyTorch that mirrors the reference's jnp code: every
contraction runs on fp32 operands (the reference's
``preferred_element_type=float32``) and the softmax statistics are fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.adapter import (dora_linear,
                                     dora_linear_column_parallel,
                                     dora_linear_row_parallel)
from repro_torch.core.config import DoRAConfig
from repro_torch.core.dispatch import plan_gather
from repro_torch.kernels.paged_gather import (paged_gather,
                                              paged_gather_plain,
                                              paged_scatter)

_F32 = torch.float32


def linear(x, w, bias=None):
    y = x @ w.T
    if bias is not None:
        y = y + bias
    return y


def maybe_dora(x, w, dora: dict | None, cfg: DoRAConfig | None, *,
               bias=None, training: bool = True, tenant_groups=None):
    """Adapted linear if a DoRA adapter is present, frozen linear
    otherwise. ``tenant_groups``: multi-tenant serving, with ``dora``
    leaves carrying a leading tenant dim (see
    ``repro_torch.core.adapter.dora_linear_grouped``); the base weight is
    shared by every tenant, so the unadapted branch ignores it."""
    if dora is None:
        return linear(x, w.detach(), bias)
    return dora_linear(x, w, dora, cfg, bias=bias, training=training,
                       tenant_groups=tenant_groups)


def _col(x, w, dora, cfg, sp, **kw):
    """A column-parallel projection under ``sp``, else :func:`maybe_dora`."""
    if sp is None:
        return maybe_dora(x, w, dora, cfg, **kw)
    return dora_linear_column_parallel(x, w, dora, cfg, sp=sp, **kw)


def _row(x, w, dora, cfg, sp, **kw):
    """A row-parallel projection under ``sp``, else :func:`maybe_dora`."""
    if sp is None:
        return maybe_dora(x, w, dora, cfg, **kw)
    return dora_linear_row_parallel(x, w, dora, cfg, sp=sp, **kw)


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


def apply_rope_partial(x, cos, sin, rotary_dim: int):
    """ChatGLM-style partial RoPE: rotate the interleaved pairs of only the
    first ``rotary_dim`` channels of each head (cos/sin [..., S,
    rotary_dim//2]) and pass the rest through."""
    rot = apply_rope(x[..., :rotary_dim], cos, sin)
    return torch.cat([rot, x[..., rotary_dim:]], dim=-1)


def mrope_cos_sin(positions3, dim: int, theta: float,
                  sections: tuple[int, int, int]):
    """M-RoPE (Qwen2-VL): three position streams (t, h, w), [3, B, S],
    each rotating one section of the dim//2 pairs: pairs [0, s0) take the
    t stream's angles, [s0, s0 + s1) the h stream's and the rest the w
    stream's. Where the three streams are equal (text, and the stub
    frontends' embeddings) it is standard RoPE."""
    assert sum(sections) == dim // 2, (sections, dim)
    (cos_t, sin_t), (cos_h, sin_h), (cos_w, sin_w) = (
        rope_cos_sin(positions3[i], dim, theta) for i in range(3))
    s0, s1, _ = sections

    def pick(t, h, w):
        return torch.cat([t[..., :s0], h[..., s0:s0 + s1],
                          w[..., s0 + s1:]], dim=-1)
    return pick(cos_t, cos_h, cos_w), pick(sin_t, sin_h, sin_w)


def sinusoidal_embedding(positions, dim: int):
    """MusicGen's fixed absolute embeddings, fp32 [..., S, dim]:
    concat([cos, sin]) (not interleaved) of positions x exp(-ln(1e4) ·
    i / half), i < half = dim // 2."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=_F32, device=positions.device) / half)
    angles = positions.to(_F32)[..., None] * freqs
    return torch.cat([torch.cos(angles), torch.sin(angles)], dim=-1)


def position_rotation(q, k, positions, mcfg):
    """q and k after the config's rotary position mode; "sinusoidal"
    rotates nothing (its embeddings are added at the input)."""
    hd = mcfg.head_dim
    if mcfg.pos_mode == "rope":
        cos, sin = rope_cos_sin(positions, hd, mcfg.rope_theta)
    elif mcfg.pos_mode == "rope_partial":
        rd = mcfg.rotary_dim
        cos, sin = rope_cos_sin(positions, rd, mcfg.rope_theta)
        return (apply_rope_partial(q, cos, sin, rd),
                apply_rope_partial(k, cos, sin, rd))
    elif mcfg.pos_mode == "mrope":
        pos3 = positions[None].expand((3,) + tuple(positions.shape))
        cos, sin = mrope_cos_sin(pos3, hd, mcfg.rope_theta,
                                 mcfg.mrope_sections)
    else:
        return q, k
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def _per_row(offset) -> bool:
    return isinstance(offset, torch.Tensor) and offset.ndim == 1


def _causal_mask_bias(q_len: int, kv_len: int, offset, device):
    """Additive fp32 causal bias. ``offset`` is the absolute position of
    the first query row: an int gives [q_len, kv_len]; a [B] tensor of
    per-row cache lengths (continuous batching: every row has its own
    causal frontier) gives [B, 1, 1, q_len, kv_len], broadcast over the
    (kv-head, group) dims of the scores."""
    steps = torch.arange(q_len, device=device)
    k_pos = torch.arange(kv_len, device=device)
    if _per_row(offset):
        q_pos = offset.long()[:, None] + steps              # [B, q]
        ok = k_pos <= q_pos[..., None]                      # [B, q, kv]
        return torch.where(ok, 0.0, -1e30).to(_F32)[:, None, None]
    q_pos = offset + steps
    ok = k_pos[None, :] <= q_pos[:, None]
    return torch.where(ok, 0.0, -1e30).to(_F32)


def attention_core(q, k, v, *, offset=0, chunk: int | None = None):
    """Grouped-query attention core. q: [B,S,Hq,hd]; k/v: [B,T,Hkv,hd].
    Queries are reshaped to [B,S,Hkv,group,hd] against the shared KV head.

    ``offset``: the first query row's position, an int or a [B] tensor of
    per-row positions. ``chunk``: online softmax over KV chunks, so the
    S×T score matrix is never materialized whole; it takes one causal
    frontier for the batch and refuses per-row offsets."""
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

    if _per_row(offset):
        raise NotImplementedError(
            "per-row cache offsets are only supported on the dense "
            "attention path (decode s==1 and short prefills); the chunked "
            "online-softmax scan assumes one causal frontier per batch")
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


def _write_rows(buf, new, pos):
    """Write new [B, s, Hkv, hd] into buf [B, T, Hkv, hd] IN PLACE at each
    row's position: ``pos`` an int (every row) or a [B] tensor (per row).
    A per-row start is clamped to [0, T - s], as the reference's
    ``dynamic_update_slice`` clamps it: only rows that no request holds
    run past T, and their content is never read."""
    s, t = new.shape[1], buf.shape[1]
    if not _per_row(pos):
        if pos + s > t:
            raise ValueError(f"KV cache of {t} positions cannot take {s} "
                             f"more at position {pos}")
        buf[:, pos:pos + s] = new.to(buf.dtype)
        return
    start = pos.long().clamp(0, t - s)
    cols = start[:, None] + torch.arange(s, device=buf.device)     # [B, s]
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    buf[rows, cols] = new.to(buf.dtype)


def attention(x, params, dora, mcfg, dcfg: DoRAConfig | None, *,
              positions, cache=None, training: bool = True,
              tenant_groups=None, sp=None):
    """Attention block: QKV (DoRA-adapted), qk-norm (an RMS norm of each
    head of q and k, before the rotation), the position rotation, core,
    O-proj.

    Returns (out, new_cache). ``cache`` = {"k", "v", "len"} and, for the
    block-paged cache, "pages".

    Rectangular: k/v are [B, T, Hkv, hd] and the new K/V rows are written
    IN PLACE into the given buffers at position "len" (the reference
    returns updated copies); attention runs over the whole buffer, whose
    unwritten rows causality masks. "len" is an int, or a [B] tensor of
    per-row lengths (continuous batching), where each row writes at its
    own position and the dense path is forced.

    Paged: k/v are block pools [n_blocks, bs, Hkv, hd] and "pages" the
    [B, max_blocks] table. The pools are gathered through the table into
    the logical [B, max_blocks * bs, Hkv, hd] view (K8 via
    :func:`~repro_torch.core.dispatch.plan_gather`), the new rows are
    written into that view, attention runs over it unchanged, and the
    view is scattered back into the pools. The view is a fresh tensor:
    the pools see the write only through the scatter. Unallocated blocks
    read as zeros and lie at or past their row's frontier, where the
    causal bias gives them a softmax weight of exactly 0.

    ``tenant_groups``: multi-tenant serving, forwarded to every adapted
    projection (the attention core is row-local and adapter-free).

    ``sp``: the sequence-parallel layout; x is this rank's [B, S/tp, D]
    rows, gathered before the projections, and the heads (and a cache's
    K/V heads, or a paged pool's, gathered through the table rows of this
    replica's slots) are this rank's."""
    if sp is not None:
        x = sp.gather(x)
    b, s, _ = x.shape
    hd = mcfg.head_dim
    dora = dora or {}

    def proj(name):
        return _col(x, params[name], dora.get(name), dcfg, sp,
                    bias=params.get(name + "_bias"), training=training,
                    tenant_groups=tenant_groups)

    q = proj("wq").reshape(b, s, -1, hd)
    k = proj("wk").reshape(b, s, -1, hd)
    v = proj("wv").reshape(b, s, -1, hd)
    if mcfg.qk_norm:
        q = rms_norm(q, params["q_norm"], mcfg.norm_eps)
        k = rms_norm(k, params["k_norm"], mcfg.norm_eps)
    q, k = position_rotation(q, k, positions, mcfg)

    if cache is None:
        out = attention_core(q, k, v, offset=0, chunk=mcfg.attn_chunk)
        new_cache = None
    else:
        pos = cache["len"]
        if not _per_row(pos):
            pos = int(pos)
        pages = cache.get("pages")
        if pages is not None:
            if not _per_row(pos):
                raise ValueError("paged K/V requires per-row lengths "
                                 "(cache_shapes(..., row_lens=True))")
            plan = plan_gather(dcfg, head_elems=k.shape[2] * hd,
                               device=cache["k"].device)
            gather = paged_gather if plan.fused else paged_gather_plain
            ck = gather(cache["k"], pages)
            cv = gather(cache["v"], pages)
        else:
            ck, cv = cache["k"], cache["v"]
        _write_rows(ck, k, pos)
        _write_rows(cv, v, pos)
        # Decode (s == 1) attends densely over the cache: its score matrix
        # is [B, Hq, 1, T], and chunking would only add steps. Per-row
        # offsets force the dense path too: the chunked scan takes one
        # causal frontier per batch.
        dense = s == 1 or _per_row(pos)
        out = attention_core(q, ck, cv, offset=pos,
                             chunk=None if dense else mcfg.attn_chunk)
        if pages is not None:
            paged_scatter(cache["k"], pages, ck)
            paged_scatter(cache["v"], pages, cv)
            new_cache = {"k": cache["k"], "v": cache["v"], "len": pos + s,
                         "pages": pages}
        else:
            new_cache = {"k": ck, "v": cv, "len": pos + s}

    out = out.reshape(b, s, -1)
    y = _row(out, params["wo"], dora.get("wo"), dcfg, sp,
             training=training, tenant_groups=tenant_groups)
    return y, new_cache


def mlp_swiglu(x, params, dora, dcfg: DoRAConfig | None, *,
               training: bool = True, tenant_groups=None, sp=None):
    d = dora or {}
    if sp is not None:
        x = sp.gather(x)
    gate = _col(x, params["w_gate"], d.get("w_gate"), dcfg, sp,
                training=training, tenant_groups=tenant_groups)
    up = _col(x, params["w_up"], d.get("w_up"), dcfg, sp,
              training=training, tenant_groups=tenant_groups)
    return _row(F.silu(gate) * up, params["w_down"], d.get("w_down"),
                dcfg, sp, training=training, tenant_groups=tenant_groups)


def mlp_gelu(x, params, dora, dcfg: DoRAConfig | None, *,
             training: bool = True, tenant_groups=None, sp=None):
    """The plain 2-matrix MLP (MusicGen): up with bias, GELU in its tanh
    form (``jax.nn.gelu``'s default), down with bias."""
    d = dora or {}
    if sp is not None:
        x = sp.gather(x)
    y = _col(x, params["w_up"], d.get("w_up"), dcfg, sp,
             bias=params["w_up_bias"], training=training,
             tenant_groups=tenant_groups)
    return _row(F.gelu(y, approximate="tanh"), params["w_down"],
                d.get("w_down"), dcfg, sp, bias=params["w_down_bias"],
                training=training, tenant_groups=tenant_groups)
