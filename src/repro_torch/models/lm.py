"""LM assembly (counterpart of ``repro/models/lm.py``): parameter specs and
init, DoRA adapter trees, the decode caches (rectangular or block-paged
K/V for attention layers, the ``h``/``conv`` states of Mamba layers) and
the forward pass, whose FFN is a dense MLP or an MoE layer
(``models/moe.py``).

Trees are plain dicts that mirror the reference's pytrees: the layer
stack is one unit whose leaves carry a leading ``[n_scan, ...]`` dim, so
a weight's "/"-joined path is the same in both packages. ``forward``
walks the stack with a Python loop over the ``n_scan`` slices where the
reference runs ``lax.scan``.

Training with ``remat="layer"`` (the reference's default) checkpoints
each layer (``torch.utils.checkpoint``, non-reentrant): only the layer
boundaries are kept and the layer's internals are recomputed in the
backward. As the reference's remat policy saves the ``"dora_wnorm"``
values, each adapted module's detached norm is computed before the
checkpointed layer and passed in, so the recompute does no norm work: K1
and K2 run once per adapted module per step.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.adapter import attach_weight_norms, init_dora_params
from repro_torch.core.config import DoRAConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models.config import ModelConfig, check_supported

_F32 = torch.float32

DEFAULT_DORA_TARGETS = ("wq", "wk", "wv", "wo",
                        "w_gate", "w_up", "w_down",
                        "in_proj", "out_proj")


def _norm_spec(mcfg: ModelConfig):
    s = {"scale": ("ones", (mcfg.d_model,))}
    if mcfg.norm_kind == "layer":
        s["bias"] = ("zeros", (mcfg.d_model,))
    return s


def _attn_spec(mcfg: ModelConfig):
    D, qd, kvd = mcfg.d_model, mcfg.q_dim, mcfg.kv_dim
    s = {"wq": ("linear", (qd, D)), "wk": ("linear", (kvd, D)),
         "wv": ("linear", (kvd, D)), "wo": ("linear", (D, qd))}
    if mcfg.qkv_bias:
        s["wq_bias"] = ("zeros", (qd,))
        s["wk_bias"] = ("zeros", (kvd,))
        s["wv_bias"] = ("zeros", (kvd,))
    if mcfg.qk_norm:
        s["q_norm"] = ("ones", (mcfg.head_dim,))
        s["k_norm"] = ("ones", (mcfg.head_dim,))
    return s


def _mlp_spec(mcfg: ModelConfig, ff: int):
    D = mcfg.d_model
    if mcfg.mlp_kind == "swiglu":
        return {"w_gate": ("linear", (ff, D)), "w_up": ("linear", (ff, D)),
                "w_down": ("linear", (D, ff))}
    return {"w_up": ("linear", (ff, D)), "w_up_bias": ("zeros", (ff,)),
            "w_down": ("linear", (D, ff)), "w_down_bias": ("zeros", (D,))}


def _moe_spec(mcfg: ModelConfig):
    """Router, stacked routed experts ("linear3", never adapted) and the
    optional shared expert behind its sigmoid gate."""
    D, E, F = mcfg.d_model, mcfg.num_experts, mcfg.moe_d_ff
    s = {"router": ("linear", (E, D)),
         "gate": ("linear3", (E, F, D)), "up": ("linear3", (E, F, D)),
         "down": ("linear3", (E, D, F))}
    if mcfg.num_shared_experts:
        s["shared"] = _mlp_spec(mcfg, mcfg.shared_d_ff)
        s["shared_gate"] = ("linear", (1, D))
    return s


def _mamba_spec(mcfg: ModelConfig):
    D, di, n = mcfg.d_model, mcfg.d_inner, mcfg.ssm_state
    dtr, k = mcfg.dt_rank, mcfg.ssm_conv
    return {"in_proj": ("linear", (2 * di, D)),
            "conv_w": ("conv", (k, di)), "conv_b": ("zeros", (di,)),
            "x_proj": ("linear", (dtr + 2 * n, di)),
            "dt_proj": ("linear", (di, dtr)), "dt_bias": ("dt_bias", (di,)),
            "A_log": ("a_log", (di, n)), "skip_d": ("ones", (di,)),
            "out_proj": ("linear", (D, di))}


def _layer_spec(mcfg: ModelConfig, kind: str, ffn: str):
    s: dict[str, Any] = {"ln1": _norm_spec(mcfg)}
    s["mixer"] = _attn_spec(mcfg) if kind == "attn" else _mamba_spec(mcfg)
    if ffn != "none":
        s["ln2"] = _norm_spec(mcfg)
        s["ffn"] = (_moe_spec(mcfg) if ffn == "moe"
                    else _mlp_spec(mcfg, mcfg.d_ff))
    return s


def unit_kinds(mcfg: ModelConfig) -> list[tuple[str, str]]:
    """(mixer kind, FFN kind) of each layer of the repeating unit, l0
    first. Layer i of the stack is layer i % period of its unit, which
    holds only if the pattern repeats every ``period`` layers: asserted."""
    kinds, ffns = mcfg.layer_kinds(), mcfg.ffn_kinds()
    p = mcfg.period
    assert all(kinds[i] == kinds[i % p] and ffns[i] == ffns[i % p]
               for i in range(mcfg.num_layers)), (mcfg.name, p)
    return list(zip(kinds[:p], ffns[:p]))


def unit_spec(mcfg: ModelConfig):
    """The repeating stack unit {"l0": layer, ...}: one attention + MLP
    layer (dense), one attention + MoE layer (MoE in every layer), one
    Mamba layer with no FFN (falcon-mamba), or jamba's eight: Mamba
    mixers with attention at index 4, a dense MLP on even indices and MoE
    on odd ones."""
    return {f"l{i}": _layer_spec(mcfg, kind, ffn)
            for i, (kind, ffn) in enumerate(unit_kinds(mcfg))}


def model_spec(mcfg: ModelConfig):
    """Leaves are (init_kind, shape) tuples, as in the reference."""
    check_supported(mcfg)
    D, V = mcfg.d_model, mcfg.vocab_size
    return {"embed": ("embed", (V, D)),
            "stack": unit_spec(mcfg),
            "final_norm": _norm_spec(mcfg),
            "head": ("linear", (V, D))}


class ShapeDtype(NamedTuple):
    """A leaf's shape and dtype, with nothing allocated (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: Any


def _map_spec(fn, spec):
    if _is_leaf_spec(spec):
        return fn(spec)
    return {k: _map_spec(fn, v) for k, v in spec.items()}


def param_shapes(mcfg: ModelConfig):
    """The params tree as :class:`ShapeDtype` leaves; stacked leaves carry
    the leading ``n_scan`` dim."""
    spec = model_spec(mcfg)
    return {k: _map_spec(
        lambda leaf, st=(k == "stack"): ShapeDtype(
            ((mcfg.n_scan,) if st else ()) + leaf[1], mcfg.dtype), v)
            for k, v in spec.items()}


def adapter_shapes(mcfg: ModelConfig, dcfg: DoRAConfig,
                   targets=DEFAULT_DORA_TARGETS):
    """The adapter tree as :class:`ShapeDtype` leaves (stacked)."""
    n, r = mcfg.n_scan, dcfg.rank
    tree: dict[str, Any] = {}
    for path, (d_out, d_in) in _adapted_paths(mcfg, targets):
        leaf = {"A": ShapeDtype((n, r, d_in), mcfg.dtype),
                "B": ShapeDtype((n, d_out, r), mcfg.dtype),
                "m": ShapeDtype((n, d_out), _F32)}
        if dcfg.cache_base_norm:
            leaf["base_sq"] = ShapeDtype((n, d_out), _F32)
        _set_path(tree, path, leaf)
    return {"stack": tree}


def _is_leaf_spec(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str)


def _spec_items(spec, path=()):
    """(path, leaf) pairs in the reference's flatten order (sorted keys)."""
    for k in sorted(spec):
        v = spec[k]
        if _is_leaf_spec(v):
            yield path + (k,), v
        else:
            yield from _spec_items(v, path + (k,))


def _set_path(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _uniform(generator, shape, lo: float, hi: float):
    u = torch.rand(shape, generator=generator, dtype=_F32,
                   device=generator.device)
    return u * (hi - lo) + lo


def _init_leaf(generator, kind, shape, dtype):
    """The reference's init distributions, drawn from ``generator``."""
    device = generator.device
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "dt_bias":
        # softplus(dt_bias) = dt ∈ [1e-3, 1e-1], log-uniform (Mamba init)
        dt = torch.exp(_uniform(generator, shape, math.log(1e-3),
                                math.log(1e-1)))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    if kind == "a_log":
        di, n = shape
        a = torch.log(torch.arange(1, n + 1, dtype=_F32, device=device))
        return a.repeat(di, 1).to(dtype)
    if kind == "conv":
        bound = 1.0 / math.sqrt(shape[0])
        return _uniform(generator, shape, -bound, bound).to(dtype)
    w = torch.randn(shape, generator=generator, dtype=_F32, device=device)
    if kind == "embed":
        return (0.02 * w).to(dtype)
    return (w / math.sqrt(shape[-1])).to(dtype)   # linear: fan-in scaled


@torch.no_grad()
def init_params(generator: torch.Generator, mcfg: ModelConfig):
    """Random weights drawn from ``generator``, on its device. Stacked
    leaves are drawn one scan slice at a time, so no fp32 copy of a whole
    stack exists."""
    device = generator.device
    n_scan = mcfg.n_scan
    params: dict[str, Any] = {}
    for path, (kind, shape) in _spec_items(model_spec(mcfg)):
        if path[0] == "stack":
            leaf = torch.empty((n_scan,) + shape, dtype=mcfg.dtype,
                               device=device)
            for i in range(n_scan):
                leaf[i] = _init_leaf(generator, kind, shape, mcfg.dtype)
        else:
            leaf = _init_leaf(generator, kind, shape, mcfg.dtype)
        _set_path(params, path, leaf)
    return params


def _adapted_paths(mcfg: ModelConfig, targets):
    """Paths into the stack unit that get adapters, with (d_out, d_in)."""
    return [(path, shape)
            for path, (kind, shape) in _spec_items(unit_spec(mcfg))
            if path[-1] in targets and kind == "linear" and len(shape) == 2]


def _get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@torch.no_grad()
def init_adapters(generator: torch.Generator, mcfg: ModelConfig, params,
                  dcfg: DoRAConfig, targets=DEFAULT_DORA_TARGETS):
    """A ~ U(±1/√d_in), B = 0, m = ||W||_row (DoRA init) per layer slice,
    on the params' device."""
    tree: dict[str, Any] = {}
    for path, _ in _adapted_paths(mcfg, targets):
        W = _get_path(params["stack"], path)         # [n_scan, d_out, d_in]
        _set_path(tree, path, init_dora_params(W, dcfg, generator=generator))
    return {"stack": tree}


def cache_shapes(mcfg: ModelConfig, batch: int, max_len: int, dtype=None,
                 *, row_lens: bool = False, block_size: int | None = None,
                 n_blocks: int | None = None, mesh=None):
    """{"stack": {"l0": {...}}, "len": ...} as (shape, dtype) pairs.

    An attention layer holds "k" and "v". Rectangular (the default): K/V
    are [n_scan, batch, max_len, Hkv, hd] and "len" is a scalar int.
    ``row_lens=True``: the continuous-batching cache, whose "len" is a
    [batch] int32 tensor of per-row lengths, so every row stands at its
    own position (``launch/engine.py``).

    ``block_size``: the block-PAGED cache. K/V become a block pool
    [n_scan, n_blocks, block_size, Hkv, hd] shared by all rows, addressed
    through the block table "pages" [batch, max_len // block_size] int32
    (-1 = unallocated, reads as zeros). ``n_blocks`` defaults to
    batch * max_len // block_size (the rectangular cache's bytes). Needs
    ``row_lens=True``, ``max_len`` a multiple of ``block_size`` and an
    attention-only stack.

    A Mamba layer holds its recurrent state "h" [n_scan, batch, d_inner,
    ssm_state] fp32 and the conv window "conv" [n_scan, batch, ssm_conv -
    1, d_inner], whatever ``max_len``.

    ``mesh``: this rank's cache of a batch served across a (data, model)
    mesh, K/V laid out by heads: each rank holds its ``Hkv / tp`` heads;
    the rectangular rows are its data replica's
    (``launch/sharding.py local_rows``: ``batch / data`` where the data
    axes split the batch, else all), a paged pool is whole on every
    replica (a pool has no batch dim, so each replica keeps its own copy
    and touches only its own rows' blocks), and "len" and "pages" are
    whole on every rank, as the host's mirrors are. Dense attention
    stacks only."""
    check_supported(mcfg)
    dtype = dtype or mcfg.dtype
    hkv, hd = mcfg.num_kv_heads, mcfg.head_dim
    kinds = [kind for kind, _ in unit_kinds(mcfg)]
    rows = batch
    if mesh is not None:
        from repro_torch.launch.sharding import local_rows
        check_mesh_supported(mcfg)
        tp = dict(mesh.shape).get("model", 1)
        if hkv % tp:
            raise ValueError(f"{mcfg.name}: {hkv} KV heads do not split "
                             f"over model={tp}")
        hkv //= tp
        sl = local_rows(mesh, batch)
        rows = sl.stop - sl.start
    paged = block_size is not None
    if paged:
        if not row_lens:
            raise ValueError("paged cache requires row_lens=True "
                             "(per-row frontiers address the block table)")
        if max_len % block_size != 0:
            raise ValueError(f"max_len={max_len} must be a multiple of "
                             f"block_size={block_size}")
        if any(k != "attn" for k in kinds):
            raise ValueError(f"paged cache requires an attention-only "
                             f"arch; {mcfg.name!r} has {kinds}")
        max_blocks = max_len // block_size
        if n_blocks is None:
            n_blocks = batch * max_blocks
        kv = ((mcfg.n_scan, n_blocks, block_size, hkv, hd), dtype)
    else:
        kv = ((mcfg.n_scan, rows, max_len, hkv, hd), dtype)
    unit = {}
    for i in range(mcfg.period):
        if kinds[i] == "attn":
            unit[f"l{i}"] = {"k": kv, "v": kv}
        else:
            unit[f"l{i}"] = {
                "h": ((mcfg.n_scan, batch, mcfg.d_inner, mcfg.ssm_state),
                      _F32),
                "conv": ((mcfg.n_scan, batch, mcfg.ssm_conv - 1,
                          mcfg.d_inner), dtype)}
    out = {"stack": unit,
           "len": (((batch,), torch.int32) if row_lens
                   else ((), torch.int64))}
    if paged:
        out["pages"] = ((batch, max_blocks), torch.int32)
    return out


def init_cache(mcfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               row_lens: bool = False, block_size: int | None = None,
               n_blocks: int | None = None, mesh=None, device=None):
    """A zeroed cache of :func:`cache_shapes` on ``device`` (with
    ``mesh``, this rank's). A scalar "len" is the Python int 0; per-row
    lengths are a zeroed tensor, and the block table starts all -1 (a
    zeroed table would alias every row to block 0)."""
    shapes = cache_shapes(mcfg, batch, max_len, dtype, row_lens=row_lens,
                          block_size=block_size, n_blocks=n_blocks,
                          mesh=mesh)
    unit = {li: {name: torch.zeros(shape, dtype=dt, device=device)
                 for name, (shape, dt) in layer.items()}
            for li, layer in shapes["stack"].items()}
    cache = {"stack": unit, "len": 0}
    if row_lens:
        shape, dt = shapes["len"]
        cache["len"] = torch.zeros(shape, dtype=dt, device=device)
    if "pages" in shapes:
        shape, dt = shapes["pages"]
        cache["pages"] = torch.full(shape, -1, dtype=dt, device=device)
    return cache


def _apply_norm(x, p, mcfg: ModelConfig):
    """RMS norm, or LayerNorm (population variance, fp32, with bias), cast
    back to x's dtype."""
    if mcfg.norm_kind == "layer":
        x32 = x.to(_F32)
        mu = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, correction=0)
        y = (x32 - mu) * torch.rsqrt(var + mcfg.norm_eps)
        y = y * p["scale"].to(_F32) + p["bias"].to(_F32)
        return y.to(x.dtype)
    return L.rms_norm(x, p["scale"], mcfg.norm_eps)


def _layer_apply(x, p, a, c, mcfg, dcfg, *, kind, ffn, positions, length,
                 training, pages=None, tenant_groups=None, sp=None):
    """Pre-norm mixer (attention or Mamba) + pre-norm FFN (a dense MLP or
    MoE, when the layer has one), residual adds. Returns (x, aux): aux is
    the MoE layer's router loss (fp32 0-d), None for other layers. ``c``
    is this layer's cache slice, written in place, or None; ``pages`` the
    block table of a paged cache. ``tenant_groups``: multi-tenant
    serving, where the adapted linears apply the per-group folded adapter
    state (attention and dense-MLP layers only). ``sp``: the
    sequence-parallel layout of a mesh (attention and dense-MLP layers
    only; :func:`forward` refuses the others)."""
    if tenant_groups is not None and (kind != "attn" or ffn == "moe"):
        raise NotImplementedError(
            f"multi-tenant grouped serving supports attention + dense-MLP "
            f"layers only; arch {mcfg.name!r} has a "
            f"{'moe ffn' if ffn == 'moe' else kind} layer")
    h = _apply_norm(x, p["ln1"], mcfg)
    a = a or {}
    if kind == "attn":
        attn_cache = None
        if c is not None:
            attn_cache = {"k": c["k"], "v": c["v"], "len": length}
            if pages is not None:
                attn_cache["pages"] = pages
        y, _ = L.attention(h, p["mixer"], a.get("mixer"), mcfg, dcfg,
                           positions=positions, cache=attn_cache,
                           training=training, tenant_groups=tenant_groups,
                           sp=sp)
    else:
        y, new_c = M.mamba_block(h, p["mixer"], a.get("mixer"), mcfg, dcfg,
                                 cache=c, training=training)
        if c is not None:
            c["h"].copy_(new_c["h"])
            c["conv"].copy_(new_c["conv"])
    x = x + y
    if ffn == "none":
        return x, None
    h = _apply_norm(x, p["ln2"], mcfg)
    if ffn == "moe":
        y, aux = MOE.moe_ffn(h, p["ffn"], a.get("ffn"), mcfg, dcfg,
                             training=training)
        return x + y, aux
    mlp = L.mlp_swiglu if mcfg.mlp_kind == "swiglu" else L.mlp_gelu
    return x + mlp(h, p["ffn"], a.get("ffn"), dcfg, training=training,
                   tenant_groups=tenant_groups, sp=sp), None


def _slice_tree(tree, i: int):
    if isinstance(tree, dict):
        return {k: _slice_tree(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack_tree(tree, n: int) -> list:
    """Stacked leaves [n, ...] → n per-slice trees through ``unbind``: the
    gradient of a stacked adapter leaf is then one stack of its n slice
    gradients, not n full-size scatters added up."""
    if isinstance(tree, dict):
        per_key = {k: _unstack_tree(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(tree.unbind(0))


def check_mesh_supported(mcfg: ModelConfig) -> None:
    """A stack runs on a mesh in this slice only if every layer is
    attention with a dense MLP."""
    if any(k != "attn" for k in mcfg.layer_kinds()) or any(
            f != "mlp" for f in mcfg.ffn_kinds()):
        raise NotImplementedError(
            f"{mcfg.name}: only dense attention stacks run on a mesh so "
            f"far; Mamba and MoE layers across ranks (multi-device SSM and "
            f"expert stacks) are ROADMAP queue 1 item 6, second half, "
            f"point 2")


def _vocab_parallel_embed(embed, tokens, mcfg: ModelConfig, sp):
    """The vocab-parallel lookup: each rank looks up the tokens its vocab
    rows hold (zeros elsewhere), and the reduce-scatter over the model
    axis sums the one non-zero row of each token into the sequence
    split. A vocab the axis does not divide is replicated: a plain lookup
    of the local rows."""
    embed = embed.detach()
    v_local = embed.shape[0]
    if v_local == mcfg.vocab_size:
        return sp.local_rows(embed[tokens])
    off = sp.mesh.axis_index(sp.axis) * v_local
    local = tokens.long() - off
    hit = (local >= 0) & (local < v_local)
    rows = embed[local.clamp(0, v_local - 1)]
    x = torch.where(hit[..., None], rows, torch.zeros_like(rows))
    return sp.scatter(x, tag="embed")


def forward(mcfg: ModelConfig, params, adapters, dcfg: DoRAConfig | None,
            *, tokens=None, embeds=None, cache=None, positions=None,
            training: bool = True, loss_slice: int | None = None,
            gather_position: int | None = None, tenant_groups=None,
            return_aux: bool = False, boundary_constraint=None):
    """Returns (logits [B, S, V], new_cache), or (logits, new_cache, aux)
    with ``return_aux``: aux is the MoE layers' router losses summed, fp32
    0-d (zero for a stack without MoE or with ``router_aux_coef`` 0), the
    reference's third result.

    ``tokens`` int [B, S], or ``embeds`` [B, S, d_model]: the precomputed
    patch or frame embeddings of a frontend stub, cast to the model's
    dtype. Exactly one is given. A "sinusoidal" config adds its fixed
    position embeddings to either.
    ``training``: the DoRA layers run their training route (norm
    recomputed from the current A/B, g differentiable); with grad enabled
    and ``mcfg.remat == "layer"`` each layer is checkpointed.
    ``cache``: the decode cache or None. Its K/V buffers (or block pools)
    and Mamba states are updated IN PLACE; the returned cache holds the same buffers with
    "len" advanced by S. A [B] "len" tensor (``row_lens=True``) positions
    each row's tokens at its own depth, len[b] + arange(S).
    ``loss_slice``: keep only the last N positions before the LM head.
    ``gather_position``: keep ONLY this position before the final norm and
    the head (logits [B, 1, V]); overrides ``loss_slice``.
    ``tenant_groups``: multi-tenant serving, static ``(start, size)`` row
    blocks grouping the batch by adapter or an int [B] tensor of per-row
    positions into the stacked tenant dim; ``adapters`` is then a stacked
    folded serving tree (leaves [n_scan, K, ...], see
    ``repro_torch.core.adapter.stack_adapter_states``). Serving only:
    ``training=False`` is required. Under a mesh the groups are this data
    replica's: static ones cut by ``launch/sharding.py
    local_tenant_groups``, a dynamic index by ``local_adapter_idx`` (the
    steps apply both), and the stacked tree is this rank's shards.
    ``boundary_constraint``: the sequence-parallel layout of a mesh
    (``launch/sharding.py make_boundary_constraint``), the explicit form
    of the reference's argument. ``params`` and ``adapters`` are then this
    rank's shards (``launch/sharding.py shard_tree``), the batch rows
    this data replica's; the embedding is a masked lookup of the local
    vocab rows summed over the model axis, the residual stream is split
    along the sequence, and the logits are this rank's vocab columns
    [B, S', V/tp] (``launch/steps.py vocab_parallel_cross_entropy``).
    A cache is this rank's (``cache_shapes(mesh=)``): its K/V heads, a
    paged pool addressed through this replica's rows of the table. Dense
    attention stacks only.
    """
    if tenant_groups is not None and training:
        raise ValueError("tenant_groups is a serving-only path "
                         "(training=False required)")
    check_supported(mcfg)
    if (tokens is None) == (embeds is None):
        raise ValueError("forward takes exactly one of tokens and embeds")
    sp = boundary_constraint
    if sp is not None:
        check_mesh_supported(mcfg)
    adapters = adapters or {}
    if embeds is None:
        x = (params["embed"].detach()[tokens] if sp is None
             else _vocab_parallel_embed(params["embed"], tokens, mcfg, sp))
    else:
        x = embeds.detach().to(mcfg.dtype)
        if sp is not None:
            x = sp.local_rows(x)
    B = x.shape[0]
    S = (tokens if embeds is None else embeds).shape[1]
    length = cache["len"] if cache is not None else None
    row_lens = isinstance(length, torch.Tensor) and length.ndim == 1
    if positions is None:
        steps = torch.arange(S, device=x.device)
        if row_lens:
            positions = length[:, None].long() + steps
        else:
            base = 0 if length is None else int(length)
            positions = (base + steps).expand(B, S)
    if mcfg.pos_mode == "sinusoidal":
        pos = positions if sp is None else sp.local_rows(positions)
        x = x + L.sinusoidal_embedding(pos, mcfg.d_model).to(x.dtype)
    # The block table of a paged cache rides beside "len": one table
    # addresses every layer's pool, read-only inside the forward.
    pages = cache.get("pages") if cache is not None else None

    stack_p = params["stack"]
    stack_a = adapters.get("stack", {})
    stack_c = cache["stack"] if cache is not None else None
    units_a = _unstack_tree(stack_a, mcfg.n_scan)
    layers = unit_kinds(mcfg)
    remat = (training and mcfg.remat == "layer" and cache is None
             and torch.is_grad_enabled())
    aux = None
    for i in range(mcfg.n_scan):
        unit_p = _slice_tree(stack_p, i)
        unit_a = units_a[i]
        unit_c = _slice_tree(stack_c, i) if stack_c is not None else None
        for j, (kind, ffn) in enumerate(layers):
            li = f"l{j}"
            a = unit_a.get(li)
            if training and a is not None:
                a = attach_weight_norms(unit_p[li], a, dcfg, sp=sp)
            c = unit_c[li] if unit_c is not None else None
            kw = dict(mcfg=mcfg, dcfg=dcfg, kind=kind, ffn=ffn,
                      positions=positions, length=length, training=training,
                      pages=pages, tenant_groups=tenant_groups, sp=sp)
            if remat:
                x, aux_l = checkpoint(_layer_apply, x, unit_p[li], a, c,
                                      use_reentrant=False,
                                      preserve_rng_state=False, **kw)
            else:
                x, aux_l = _layer_apply(x, unit_p[li], a, c, **kw)
            if aux_l is not None:
                aux = aux_l if aux is None else aux + aux_l
    new_cache = None
    if cache is not None:
        new_cache = {"stack": stack_c,
                     "len": length + S if row_lens else int(length) + S}
        if pages is not None:
            new_cache["pages"] = pages

    if sp is not None:
        x = sp.gather(x, tag="final")
    if gather_position is not None:
        x = x[:, gather_position:gather_position + 1]
    elif loss_slice is not None and loss_slice < x.shape[1]:
        x = x[:, -loss_slice:]
    x = _apply_norm(x, params["final_norm"], mcfg)
    logits = x @ params["head"].detach().T
    if return_aux:
        if aux is None:
            aux = torch.zeros((), dtype=_F32, device=logits.device)
        return logits, new_cache, aux
    return logits, new_cache
