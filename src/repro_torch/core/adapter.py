"""DoRA adapter: parameter init and the adapted linear (counterpart of
``repro/core/adapter.py``), single-tenant.

    ΔY = g ⊙ (s · X·Aᵀ·Bᵀ) + (g − 1) ⊙ Y_base,   Y = Y_base + ΔY
    g  = m / max(w_norm, ε),   w_norm = ||W + s·B·A||_row (fp32, detached)

Weights follow the paper's [d_out, d_in] convention. ``dora_linear``
routes through :mod:`repro_torch.core.dispatch`: the matmul-fused compose
(K6 forward, K7 backward) when the plan says so, else y_lora is
materialized and composed by the element-wise kernels (K3 or K4 forward,
K5 backward) or eagerly. Under ``training=True`` the norm is computed
detached and g = m / max(w_norm, eps) carries the gradient to m (unless
``magnitude_trainable=False``).

Frozen-adapter serving state (:func:`precompute_adapter_state`): during
generation A/B/m are frozen, so g is computed once per adapter set and
carried as a ``"g"`` leaf; a tree carrying it is refused under
``training=True``.

Multi-tenant serving (:func:`dora_linear_grouped`): one call serves a batch
whose rows use different adapters, out of K folded serving states stacked
leaf-wise (:func:`stack_adapter_states`). The base projection is one
product over the whole batch; each tenant's rows then take the
homogeneous serving path's delta (:func:`gsb_delta`).

Under a mesh (``constrain``: a ``core/sharding.py`` plan, or an object
carrying one as ``.plan``) the tensors are each rank's shards: the
compose runs shard-local with the plan's collectives, and with
``axis_name`` the norm's partials are summed over that axis
(:func:`~repro_torch.core.factored_norm.factored_norm_sharded`). The
serving state is precomputed on the same shards
(:func:`precompute_adapter_state` with ``sp``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import compose as _compose
from repro_torch.core import dispatch as _dispatch
from repro_torch.core import factored_norm as _norm
from repro_torch.core import sharding as _sh
from repro_torch.core.config import DoRAConfig
from repro_torch.kernels import ops as _kops
from repro_torch.tree import tree_map

_F32 = torch.float32


@torch.no_grad()
def init_dora_params(W, cfg: DoRAConfig, *, generator: torch.Generator,
                     m_dtype=_F32):
    """A ~ U(-1/√d_in, 1/√d_in), B = 0, m = ||W||_row (DoRA init). Stacked
    weights [..., d_out, d_in] get stacked leaves. A is drawn on the
    generator's device and moved to W's."""
    if W.ndim > 2:
        leaves = [init_dora_params(w, cfg, generator=generator,
                                   m_dtype=m_dtype) for w in W]
        return {k: torch.stack([lf[k] for lf in leaves])
                for k in leaves[0]}
    d_out, d_in = W.shape
    bound = 1.0 / (d_in ** 0.5)
    u = torch.rand((cfg.rank, d_in), generator=generator,
                   device=generator.device, dtype=_F32)
    A = ((u * 2.0 - 1.0) * bound).to(device=W.device, dtype=W.dtype)
    B = torch.zeros((d_out, cfg.rank), dtype=W.dtype, device=W.device)
    base_sq, _, _ = _norm.factored_norm_terms(W, A, B, compute_cross=False)
    m = torch.sqrt(torch.clamp_min(base_sq, 0.0)).to(m_dtype)
    out = {"A": A, "B": B, "m": m}
    if cfg.cache_base_norm:
        out["base_sq"] = base_sq
    return out


@torch.no_grad()
def compute_weight_norm(W, A, B, cfg: DoRAConfig, *, axis_name=None,
                        mesh=None, base_sq_cache=None):
    """Detached fp32 [d_out] row norm of the composed weight, routed
    through the configured implementation and the norm plan.
    ``axis_name``: W and A are this rank's d_in shards along that axis of
    ``mesh``; only the factored algebra distributes, so the partials are
    summed there (K1 without its epilogue and the standalone K2 on the
    kernel route)."""
    plan = _dispatch.plan_norm(cfg, d_out=W.shape[0], device=W.device)
    if axis_name is not None:
        if mesh is None:
            raise ValueError("compute_weight_norm(axis_name=...) needs the "
                             "mesh whose axis it sums over")
        return _norm.factored_norm_sharded(
            W, A, B, cfg.scaling, axis_name=axis_name, mesh=mesh,
            chunk_mb=cfg.resolve_chunk_mb(), base_sq_cache=base_sq_cache,
            kernels=plan.fused)
    if cfg.norm_impl == "peft_eye":
        return _norm.norm_peft_eye(W, A, B, cfg.scaling)
    if cfg.norm_impl == "dense_ba":
        return _norm.norm_dense_ba(W, A, B, cfg.scaling)
    if plan.fused:
        return _kops.fused_norm(W, A, B, cfg.scaling,
                                base_sq_cache=base_sq_cache)
    return _norm.factored_norm(W, A, B, cfg.scaling,
                               chunk_mb=cfg.resolve_chunk_mb(),
                               base_sq_cache=base_sq_cache)


def _row_count(shape) -> int:
    rows = 1
    for d in shape[:-1]:
        rows *= d
    return rows


def compose_delta(y_base, y_lora, g, cfg: DoRAConfig, *, training: bool,
                  shape: tuple[int, int] | None = None):
    """Compose a materialized y_lora through the dispatch (never
    matmul-fused: the rank is unknown here). ``shape``: the (rows, d_out)
    the route is chosen for, when the tensors are one rank's shards of
    it."""
    _compose.check_broadcast(g, y_base)
    rows, d_out = shape or (_row_count(y_base.shape), y_base.shape[-1])
    plan = _dispatch.plan_compose(cfg, training=training, rows=rows,
                                  d_out=d_out, device=y_base.device)
    if plan.tier is _dispatch.Tier.EAGER:
        return _compose.compose_stable(y_base, y_lora, g, cfg.scaling)
    if plan.tier is _dispatch.Tier.FUSED_FWD:
        return _kops.fused_compose(y_base, y_lora, g.detach(), cfg.scaling,
                                   save_inner=False, mag_grad=False)
    return _kops.fused_compose(
        y_base, y_lora, g, cfg.scaling,
        save_inner=cfg.save_inner and cfg.magnitude_trainable,
        mag_grad=cfg.magnitude_trainable)


def compose_delta_factored(y_base, h, B, g, cfg: DoRAConfig, *,
                           training: bool, sharding=None):
    """Compose from the factored LoRA activation h = x·Aᵀ: matmul-fused
    (K6/K7, y_lora never written) when the plan allows, else y_lora is
    materialized once and :func:`compose_delta` runs.

    ``sharding``: the call site's mesh plan, the tensors this rank's
    shards under it. The route is chosen for the whole tensor, as the
    reference chooses it. A matmul-fused route runs shard-local with the
    plan's collectives; the materialized route gets the same sums through
    :func:`~repro_torch.core.sharding.grad_psum` (B's and g's gradients
    over the row axes, d_h over the d_out axes where the plan sums it)."""
    _compose.check_broadcast(g, y_base)
    rows, d_out = _row_count(y_base.shape), y_base.shape[-1]
    if sharding is not None:
        rows, d_out = rows * sharding.row_shards, d_out * sharding.dout_shards
    plan = _dispatch.plan_compose(cfg, training=training, rows=rows,
                                  d_out=d_out, rank=B.shape[-1],
                                  sharding=sharding, device=y_base.device)
    if plan.matmul_fused:
        mag_grad = cfg.magnitude_trainable
        if plan.tier is _dispatch.Tier.FUSED_FWD:
            g = g.detach()
            mag_grad = False
        return _kops.fused_compose_mm(y_base, h, B, g, cfg.scaling,
                                      mag_grad=mag_grad,
                                      sharding=plan.sharding)
    if sharding is not None and training:
        mesh = sharding.mesh
        B = _sh.grad_psum(B, sharding.row_axes, mesh, tag="compose.T")
        g = _sh.grad_psum(g, sharding.row_axes, mesh, tag="compose.d_g")
        if sharding.psum_dh:
            h = _sh.grad_psum(h, sharding.dout_axes, mesh, tag="compose.d_h")
    y_lora = h @ B.T
    return compose_delta(y_base, y_lora, g, cfg, training=training,
                         shape=(rows, d_out))


def gsb_delta(y_base, h, g, gsB):
    """The serving fast path's delta from a folded state: g·s pre-folded
    into B, so the compose is the fp32 product h·gsBᵀ and one fused
    multiply-add, (g − 1)·y_base + t, in the activation dtype."""
    t = h.to(_F32) @ gsB.detach().to(_F32).T
    return ((g - 1.0) * y_base.to(_F32) + t).to(y_base.dtype)


def dora_linear(x, W, adapter: dict[str, Any], cfg: DoRAConfig, *,
                bias=None, training: bool = True, axis_name=None,
                base_sq_cache=None, constrain=None, tenant_groups=None):
    """Adapted linear: x [..., d_in] → y [..., d_out].

    W: frozen [d_out, d_in]; adapter: {"A": [r, d_in], "B": [d_out, r],
    "m": [d_out]} plus optional "base_sq" (precomputed ||W||²_row; also
    ``base_sq_cache``), the serving state of
    :func:`precompute_adapter_state` ("g", optionally "gsB") and
    "w_norm". A cached "g" skips the factored norm and is refused under
    ``training=True``. "w_norm" is the detached norm of this step's A and
    B, computed by the caller: the layer-remat training forward computes
    it before the checkpointed layer so that the recompute in the
    backward does no norm work (the reference's remat policy saves it
    under the name "dora_wnorm").

    ``constrain``: the call site's mesh plan (a
    :class:`~repro_torch.core.sharding.ComposeSharding` or an object
    carrying one as ``.plan``); x, W and the adapter are then this rank's
    shards and the compose runs under it. ``axis_name``: W and A are
    split along d_in over that axis of the plan's mesh, and the norm's
    partials are summed over it. The serving state ("g", "gsB") is taken
    under a plan as this rank's shards (:func:`precompute_adapter_state`
    with ``sp``), and so is a K-stacked one with static tenant groups: a
    column-parallel module's W, g and gsB are its local rows, and the
    grouped compose is row-local, with no collective.

    ``tenant_groups``: multi-tenant serving, a tuple of ``(start, size)``
    row blocks (or a data replica's ``(start, size, k)``) or an int [B]
    tensor of per-row tenant positions, over an adapter tree whose leaves
    carry a leading tenant dim K (see :func:`dora_linear_grouped`)."""
    plan_sh = _sh.as_compose_sharding(constrain)
    if axis_name is not None and plan_sh is None:
        raise ValueError("dora_linear(axis_name=...) needs a mesh plan "
                         "(constrain=) to name the mesh")
    if tenant_groups is not None:
        return dora_linear_grouped(x, W, adapter, cfg, tenant_groups,
                                   bias=bias, training=training,
                                   constrain=plan_sh)
    W = W.detach()
    y_base = x @ W.T
    h = x @ adapter["A"].T
    if plan_sh is not None:
        y_base, h = plan_sh(y_base), plan_sh.constrain_h(h)
    return _adapted_output(
        y_base, h, W, adapter, cfg, dtype=x.dtype, training=training,
        bias=bias, axis_name=axis_name, sharding=plan_sh,
        base_sq_cache=base_sq_cache)


def _adapted_output(y_base, h, W, adapter, cfg: DoRAConfig, *, dtype,
                    training: bool, bias=None, axis_name=None, sharding=None,
                    base_sq_cache=None):
    """y = y_base + delta (+ bias) from y_base = x·Wᵀ and h = x·Aᵀ: the
    magnitude scale g (the serving state's, or m over the norm of W + s·BA:
    the caller's "w_norm", else computed here, its partials summed over
    ``axis_name`` of the plan's mesh when W and A are d_in shards), then
    the compose under ``sharding``; the bias is re-added after it."""
    A, B, m = adapter["A"], adapter["B"], adapter["m"]
    if "g" in adapter:
        if training:
            raise ValueError(
                "adapter tree carries precomputed serving state ('g'), "
                "which is stale the moment A/B/m change: it is invalid "
                "under training=True. Train on the raw adapter tree and "
                "rebuild the state with precompute_adapter_state() after "
                "the update.")
        g = adapter["g"].detach().to(_F32)
    else:
        w_norm = adapter.get("w_norm")
        if w_norm is None:
            if base_sq_cache is None:
                base_sq_cache = adapter.get("base_sq")
            w_norm = compute_weight_norm(
                W, A, B, cfg, axis_name=axis_name,
                mesh=None if sharding is None else sharding.mesh,
                base_sq_cache=base_sq_cache)
        g = _compose.magnitude_scale(m, w_norm.detach(),
                                     _norm.dtype_eps(dtype))
    if not cfg.magnitude_trainable:
        g = g.detach()
    if "gsB" in adapter and not training:
        delta = gsb_delta(y_base, h, g, adapter["gsB"])
    else:
        delta = compose_delta_factored(y_base, h, B, g, cfg,
                                       training=training, sharding=sharding)
    y = y_base + delta
    if bias is not None:
        y = y + bias                 # re-added after the compose
    return y


def dora_linear_row_parallel(x, W, adapter: dict[str, Any] | None,
                             cfg: DoRAConfig | None, *, sp, bias=None,
                             training: bool = True, tenant_groups=None):
    """A row-parallel adapted linear under the mesh layout ``sp``
    (``core/sharding.py SequenceParallel``): x [B, S, d_in_l] holds this
    rank's d_in columns on every row, W [d_out, d_in_l] and A [r, d_in_l]
    its d_in shards, B, m, the bias and the serving state (g, gsB) whole.

    The partial y_base = x·Wᵀ and the rank-space h = x·Aᵀ, in fp32
    (``sp.partial``) when ``sp.axis`` splits d_in, are reduce-scattered
    to the sequence split ([B, S/tp, ...]), or, with no split (decode),
    all-reduced, then rounded to x's dtype; the norm's partials are
    summed over ``sp.axis`` unless the serving state's g is given; the
    compose then runs on the full d_out under ``sp.row_plan`` (rows
    split: T and d_g summed over the axis in the backward). Returns y
    [B, S/tp, d_out], or [B, S, d_out] with no split.

    ``tenant_groups``: static groups over a K-stacked folded serving tree
    (:func:`dora_linear_grouped`'s form). Each group's partial h is
    computed with its own A, the groups' partials are concatenated along
    the batch rows into one [B, S, r] tensor and go through the one
    scatter of h, then each group takes :func:`gsb_delta` on its rows: a
    grouped call moves exactly the bytes of a single-tenant one. An int
    [B] tensor of per-row stack positions (this data replica's rows):
    the dynamic compose (:func:`_row_parallel_dyn`), whose one scatter of
    h moves the same bytes."""
    _check_serving_state(adapter, sp)
    y_base = sp.scatter(sp.partial(x, W.detach()), tag="y_base").to(x.dtype)
    if adapter is None:
        return y_base if bias is None else y_base + bias
    plan = sp.row_plan
    if isinstance(tenant_groups, torch.Tensor):
        return _row_parallel_dyn(x, plan(y_base), adapter, tenant_groups,
                                 sp=sp, bias=bias, training=training)
    if tenant_groups is not None:
        return _row_parallel_grouped(x, plan(y_base), adapter, tenant_groups,
                                     sp=sp, bias=bias, training=training)
    h = sp.scatter(sp.partial(x, adapter["A"]), tag="h").to(x.dtype)
    return _adapted_output(plan(y_base), plan.constrain_h(h), W, adapter,
                           cfg, dtype=x.dtype, training=training, bias=bias,
                           axis_name=sp.axis, sharding=plan)


@torch.no_grad()
def _row_parallel_grouped(x, y_base, adapter, tenant_groups, *, sp, bias,
                          training: bool):
    """The grouped compose of :func:`dora_linear_row_parallel` from its
    scattered y_base: the per-group partial h, one scatter, then each
    group's :func:`gsb_delta` with the whole g[k] and gsB[k]."""
    A, g, gsB = _grouped_state(adapter, training)
    groups = tenant_positions(tenant_groups, x.shape[0], A.shape[0])
    h = torch.cat([sp.partial(x[s:s + n], A[k]) for s, n, k in groups])
    h = sp.row_plan.constrain_h(sp.scatter(h, tag="h").to(x.dtype))
    deltas = [gsb_delta(y_base[s:s + n], h[s:s + n], g[k].to(_F32), gsB[k])
              for s, n, k in groups]
    y = y_base + torch.cat(deltas, dim=0)
    if bias is not None:
        y = y + bias                 # re-added after the compose
    return y


@torch.no_grad()
def _row_parallel_dyn(x, y_base, adapter, idx, *, sp, bias, training: bool):
    """The dynamic compose of :func:`dora_linear_row_parallel` from its
    scattered y_base. The all-K partial x·A_kᵀ on this rank's d_in (fp32,
    ``sp.partial``, where ``sp.axis`` splits it; on one rank the
    no-mesh path's einsum), then each row's position selected BEFORE the
    one scatter of h: the select is a pure gather, so it commutes with
    the sum, and the scatter moves [B, S, r] as a single-tenant call
    does, not [B, S, K, r]. Then the K-batched fp32 h·gsBᵀ on the whole
    d_out and the row's select again (:func:`_dyn_output`)."""
    A, g, gsB = _grouped_state(adapter, training)
    _check_dyn_rows(x)
    idx = torch.as_tensor(idx, device=x.device).long()
    K, r = A.shape[0], A.shape[1]
    if sp.tp == 1:
        h_all = torch.einsum("bsd,krd->bskr", x, A)
    else:
        h_all = sp.partial(x, A.reshape(K * r, A.shape[-1])).reshape(
            *x.shape[:-1], K, r)
    h = sp.scatter(_compose.select_tenant(h_all, idx), tag="h").to(x.dtype)
    return _dyn_output(y_base, sp.row_plan.constrain_h(h), g, gsB, idx,
                       bias)


def dora_linear_column_parallel(x, W, adapter: dict[str, Any] | None,
                                cfg: DoRAConfig | None, *, sp, bias=None,
                                training: bool = True, tenant_groups=None):
    """A column-parallel adapted linear under ``sp``: x [B, S, d_in] the
    gathered (or, with no split, whole) rows, W [d_out_l, d_in], B and
    gsB [d_out_l, r], m, g and the bias this rank's d_out shards, A
    whole. The norm is local (W's rows are), or the serving state's g is
    given; the compose runs under ``sp.col_plan``, which leaves d_h's
    partial to the gather's backward, so A's gradient is summed over
    ``sp.axis``. ``tenant_groups``: the grouped compose on these shards
    (:func:`dora_linear_grouped`), static or dynamic, with no
    collective."""
    _check_serving_state(adapter, sp)
    if adapter is None:
        y = x @ W.detach().T
        return y if bias is None else y + bias
    A = adapter["A"]
    if A.requires_grad:
        adapter = {**adapter, "A": sp.reduce_grad(A)}
    return dora_linear(x, W, adapter, cfg, bias=bias, training=training,
                       constrain=sp.col_plan, tenant_groups=tenant_groups)


def _check_serving_state(adapter, sp) -> None:
    """The decode layout (``sp.seq_split`` False) expects the serving
    state: a raw leaf would redo its norm, and its sums over the model
    axis, on every token."""
    if adapter is not None and not sp.seq_split and "g" not in adapter:
        raise ValueError(
            "the decode step under a mesh takes the serving state: an "
            "adapter leaf without 'g' reached it; precompute it with "
            "make_precompute_step(mcfg, scfg, mesh) (generate and "
            "AdapterStateCache.for_serving(mesh=) do)")


def dora_linear_stacked(x, W, adapter: dict[str, Any], cfg: DoRAConfig, *,
                        bias=None, training: bool = True,
                        base_sq_cache=None):
    """:func:`dora_linear` over a leading stack dim (the experts of an MoE
    layer): x [E, ..., d_in], W [E, d_out, d_in], adapter leaves stacked
    on dim 0, ``bias`` and ``base_sq_cache`` [E, d_out] when given (the
    cache takes the place of the adapter's own "base_sq"). One call per
    slice, the results stacked, as the reference's ``vmap`` computes."""
    out = []
    for e in range(W.shape[0]):
        ad = {k: v[e] for k, v in adapter.items()}
        if base_sq_cache is not None:
            ad["base_sq"] = base_sq_cache[e]
        out.append(dora_linear(x[e], W[e], ad, cfg,
                               bias=None if bias is None else bias[e],
                               training=training))
    return torch.stack(out)


def check_tenant_groups(tenant_groups, batch: int) -> tuple:
    """Validate a multi-tenant grouping: a tuple of ``(start, size)`` row
    blocks that tile ``[0, batch)`` contiguously in order (the server sorts
    request rows by adapter before building the step)."""
    groups = tuple((int(s), int(n)) for s, n in tenant_groups)
    if not groups:
        raise ValueError("tenant_groups must name at least one group")
    expect = 0
    for k, (start, size) in enumerate(groups):
        if start != expect or size < 1:
            raise ValueError(
                f"tenant_groups must tile the batch contiguously: group "
                f"{k} is (start={start}, size={size}) but rows 0..{expect} "
                f"are covered so far (groups={groups})")
        expect = start + size
    if expect != batch:
        raise ValueError(
            f"tenant_groups {groups} cover {expect} rows, batch has {batch}")
    return groups


def tenant_positions(tenant_groups, batch: int, K: int) -> tuple:
    """The static groups as ``(start, size, k)`` triples: whole-batch
    ``(start, size)`` groups, one per stack position k in order, or a
    data replica's triples (``launch/sharding.py local_tenant_groups``),
    whose k name the positions of the groups that reach its rows. Either
    form tiles ``[0, batch)`` contiguously (:func:`check_tenant_groups`)."""
    groups = tuple(tuple(int(v) for v in grp) for grp in tenant_groups)
    local = bool(groups) and len(groups[0]) == 3
    if any(len(grp) != (3 if local else 2) for grp in groups):
        raise ValueError(f"tenant_groups {groups} mix (start, size) pairs "
                         f"and (start, size, k) triples")
    check_tenant_groups([grp[:2] for grp in groups], batch)
    if not local:
        if len(groups) != K:
            raise ValueError(
                f"{len(groups)} tenant groups but the stacked adapter tree "
                f"carries K={K} tenants")
        return tuple((s, n, k) for k, (s, n) in enumerate(groups))
    if any(not 0 <= k < K for *_, k in groups):
        raise ValueError(f"tenant_groups {groups} name a stack position "
                         f"outside the K={K} tenants")
    return groups


def _grouped_state(adapter, training: bool):
    """(A, g, gsB) of a K-stacked folded serving tree; refused under
    training or without the folded state."""
    if training:
        raise ValueError(
            "dora_linear_grouped is a serving-only path: the grouped "
            "compose consumes precomputed per-tenant state ('g'/'gsB') "
            "that is stale the moment A/B/m change. Train per-tenant on "
            "the raw adapter trees.")
    missing = [k for k in ("g", "gsB") if k not in adapter]
    if missing:
        raise ValueError(
            f"multi-tenant grouped serving needs the FOLDED per-tenant "
            f"state (missing {missing!r} leaves): precompute each "
            f"tenant with precompute_adapter_state(..., fold_gsb=True) "
            f"(AdapterStateCache.for_serving does) and stack with "
            f"stack_adapter_states before building the grouped step.")
    return adapter["A"], adapter["g"], adapter["gsB"]


@torch.no_grad()
def dora_linear_grouped(x, W, adapter: dict[str, Any], cfg: DoRAConfig,
                        tenant_groups, *, bias=None, training: bool = False,
                        constrain=None):
    """Multi-tenant adapted linear: one call serves a batch whose rows use
    per-row adapters out of a K-stacked serving tree (x [B, ..., d_in]).

    ``adapter`` leaves carry a leading tenant dim K
    (:func:`stack_adapter_states`) and must be a folded serving tree, with
    ``"g"`` and ``"gsB"`` from ``precompute_adapter_state(fold_gsb=True)``,
    so no tenant does norm work per token. ``cfg`` is unused: the folded
    state carries s, and no kernel route applies.

    ``tenant_groups`` selects one of two grouping contracts:

    - **Static** (a tuple of ``(start, size)`` row blocks, one per stack
      position in order, or a data replica's ``(start, size, k)``
      triples, :func:`tenant_positions`): the base projection x·Wᵀ is
      one product over the whole batch, then each group's rows take
      exactly the ops of the homogeneous serving path (h = x_k·A_kᵀ,
      then :func:`gsb_delta`), so a group's delta is bitwise the
      homogeneous path's on the same rows and the same y_base rows.
    - **Dynamic** (an int [B] tensor of per-row stack positions): every
      tenant's contribution is computed by one K-batched contraction and
      each row's result is then a pure gather
      (:func:`repro_torch.core.compose.select_tenant`), at K times the
      adapter FLOPs; see :func:`_dora_linear_dyn`.

    ``constrain``: the call site's mesh plan, as :func:`dora_linear`
    takes it; the leaves are then this rank's shards (a column-parallel
    module's W, g and gsB its local rows) and the compose is row-local."""
    del cfg
    A, g, gsB = _grouped_state(adapter, training)
    if W.ndim > 2:
        raise NotImplementedError(
            "grouped multi-tenant serving of stacked/expert weights "
            f"(W rank {W.ndim}) is not supported")
    if not isinstance(tenant_groups, (tuple, list)):
        return _dora_linear_dyn(x, W, A, g, gsB, tenant_groups, bias=bias,
                                constrain=constrain)
    groups = tenant_positions(tenant_groups, x.shape[0], A.shape[0])
    y_base = x @ W.T
    deltas = [gsb_delta(y_base[start:start + size],
                        x[start:start + size] @ A[k].T,
                        g[k].to(_F32), gsB[k])
              for start, size, k in groups]
    y = y_base + torch.cat(deltas, dim=0)
    if bias is not None:
        y = y + bias                 # re-added after the compose
    return y


def _check_dyn_rows(x) -> None:
    if x.ndim != 3:
        raise NotImplementedError(
            f"dynamic grouped serving expects [B, S, d_in] activations "
            f"(got ndim={x.ndim}); the serving steps always run the "
            f"model's batched token layout")


def _dora_linear_dyn(x, W, A, g, gsB, idx, *, bias=None, constrain=None):
    """Dynamic grouped compose: per-row adapters selected by the int [B]
    stack position ``idx``. The K-batched products below reduce over the
    same axes as the homogeneous path's ``x @ Aᵀ`` and fp32 ``h·gsBᵀ``, and
    the per-row select is a pure gather; the g term is row-local,
    applied from the gathered ``g[idx]``. ``constrain``: the call site's
    mesh plan (a column-parallel module's local rows of W, g and gsB; no
    collective), whose shape check y_base takes."""
    _check_dyn_rows(x)
    idx = torch.as_tensor(idx, device=x.device).long()
    y_base = x @ W.T
    plan_sh = _sh.as_compose_sharding(constrain)
    if plan_sh is not None:
        y_base = plan_sh(y_base)
    # All-K down-projection, then the gather: [B, S, K, r].
    h = _compose.select_tenant(torch.einsum("bsd,krd->bskr", x, A), idx)
    return _dyn_output(y_base, h, g, gsB, idx, bias)


def _dyn_output(y_base, h, g, gsB, idx, bias):
    """y from y_base and each row's own h: the all-K folded up-projection
    in fp32 ([B, S, K, d_out]), each row's position selected, and the
    row-local g term from the gathered ``g[idx]``."""
    t = _compose.select_tenant(
        torch.einsum("bsr,kor->bsko", h.to(_F32), gsB.to(_F32)), idx)
    g_row = g.to(_F32).index_select(0, idx)             # [B, d_out]
    delta = ((g_row[:, None, :] - 1.0) * y_base.to(_F32) + t).to(
        y_base.dtype)
    y = y_base + delta
    if bias is not None:
        y = y + bias
    return y


def stack_adapter_states(states, *, axis: int = 0):
    """Stack K congruent per-tenant serving trees leaf-wise along a new
    tenant dim at ``axis`` (0 for bare adapter leaves; the model-level
    trees of ``make_precompute_step`` use axis=1 so the layer-stack dim
    stays leading: leaves go [n_scan, ...] → [n_scan, K, ...]). The
    stacked leaves are fresh tensors."""
    states = list(states)
    if not states:
        raise ValueError("need at least one per-tenant state to stack")
    return tree_map(lambda *leaves: torch.stack(leaves, dim=axis),
                    *states)


def _is_adapter_leaf(node) -> bool:
    return isinstance(node, dict) and {"A", "B", "m"} <= set(node.keys())


@torch.no_grad()
def precompute_adapter_state(params, adapters, cfg: DoRAConfig, *,
                             act_dtype=None, fold_gsb: bool = False,
                             sp=None):
    """A NEW adapter tree whose leaves also carry ``"g"`` (fp32 [d_out],
    with the eps of ``act_dtype``) and, with ``fold_gsb``, ``"gsB"``
    (fp32 [d_out, r], g·s folded into B). Stacked leaves ([n_scan, ...])
    are handled slice by slice. Serving only: any update to A/B/m makes
    the state stale.

    ``sp``: the mesh layout (``core/sharding.py SequenceParallel``);
    params and adapters are this rank's shards. A module whose W is split
    along d_in (``sp.norm_axis(name)``: wo, w_down) sums its norm's
    partials over that axis (K1's terms, three sums, the standalone K2 on
    the kernel route); a column-parallel one takes its local rows' norm
    (K1 with its epilogue), with no collective. g lands laid out like m
    and gsB like B (``launch/sharding.py adapter_sharding(serving=
    True)``)."""
    eps = _norm.dtype_eps(act_dtype if act_dtype is not None else _F32)

    def leaf_g(W, ad, axis):
        if W.ndim > 2:
            return torch.stack([
                leaf_g(W[i], {k: v[i] for k, v in ad.items()}, axis)
                for i in range(W.shape[0])])
        w_norm = compute_weight_norm(
            W, ad["A"], ad["B"], cfg, axis_name=axis,
            mesh=None if axis is None else sp.mesh,
            base_sq_cache=ad.get("base_sq"))
        return _compose.magnitude_scale(ad["m"], w_norm, eps)

    def leaf_state(W, ad, name):
        out = {k: v for k, v in ad.items() if k not in ("g", "gsB")}
        out["g"] = leaf_g(W, out, None if sp is None else sp.norm_axis(name))
        if fold_gsb:
            gs = out["g"] * _compose.f32(cfg.scaling)
            out["gsB"] = gs[..., :, None] * ad["B"].to(_F32)
        return out

    def walk(p_node, a_node, name=None):
        if _is_adapter_leaf(a_node):
            return leaf_state(p_node, a_node, name)
        return {k: walk(p_node[k], v, k) for k, v in a_node.items()}

    return walk(params, adapters)


@torch.no_grad()
def attach_weight_norms(params, adapters, cfg: DoRAConfig, *, sp=None,
                        name: str | None = None):
    """A NEW adapter tree whose unstacked leaves also carry ``"w_norm"``,
    the detached fp32 [d_out] norm of their current A and B (K1 with its
    epilogue on the kernel route). The training forward
    (``models/lm.py``) calls it before each layer, which layer remat
    checkpoints, so the layer's recompute in the backward reuses the norm
    instead of running the factored norm again. Leaves carrying serving
    state ("g") are left as they are, for :func:`dora_linear` to refuse
    under training.

    ``sp``: the mesh layout (``core/sharding.py SequenceParallel``); a
    module whose W is split along d_in (``sp.norm_axis(name)``) sums its
    norm's partials over that axis."""
    if _is_adapter_leaf(adapters):
        if "g" in adapters:
            return adapters
        axis = None if sp is None else sp.norm_axis(name)
        return {**adapters, "w_norm": compute_weight_norm(
            params, adapters["A"], adapters["B"], cfg, axis_name=axis,
            mesh=None if axis is None else sp.mesh,
            base_sq_cache=adapters.get("base_sq"))}
    return {k: attach_weight_norms(params[k], v, cfg, sp=sp, name=k)
            for k, v in adapters.items()}


def invalidate_adapter_state(adapters):
    """Strip the serving-state leaves ("g"/"gsB"): the inverse of
    :func:`precompute_adapter_state`."""
    if _is_adapter_leaf(adapters):
        return {k: v for k, v in adapters.items() if k not in ("g", "gsB")}
    return {k: invalidate_adapter_state(v) for k, v in adapters.items()}


@dataclasses.dataclass(frozen=True)
class DoRAParamSpec:
    """Bookkeeping for one adapted weight (``repro/core/adapter.py:551``):
    used by optimizer masking and sharding-rule generation."""
    path: str
    d_out: int
    d_in: int
    rank: int
