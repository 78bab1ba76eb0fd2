"""Sharding rules for a mesh, with divisibility fallback (counterpart of
``repro/launch/sharding.py``).

The rules are the reference's, kept as they stand (its DESIGN.md §5):

  - **Base weights**: TP over ``model`` on the hidden/head dim + FSDP over
    (``pod``, ``data``) on the other dim.
  - **Adapters (A, B, m)**: congruent with their base weight's TP axis
    only; never FSDP-sharded; replicated over the data axes.
  - **Batch**: over (``pod``, ``data``). **Activations**: the sequence
    over ``model`` (sequence parallelism).
  - **Decode caches**: batch over (pod, data), KV seq over ``model``.

Every rule goes through :func:`pick_axes`, which drops to smaller axis
sets (and finally replication) when a dim does not divide. The rules
return the port's :class:`~repro_torch.core.sharding.PartitionSpec`
trees; the meshes they read may be duck-typed (``axis_names`` and a
``shape`` dict). :func:`shard_tree` cuts this rank's slices out of a
full tree (``jax.device_put`` with shardings) and :func:`unshard_tree`
gathers them back.

What the runtime honours so far (``models/lm.py`` under a mesh): the TP
over ``model``, with its sequence parallelism in the train step and the
prefill and with the sequence whole in the decode, draft and verify
steps, the data axes as batch replicas, and the serving leaves of
``adapter_sharding(serving=True)``. Specs that name an FSDP axis on a
weight (``fsdp`` on a pod axis, ``fsdp_data``, ``fsdp_gather``,
``expert``), the ZeRO-1 layout of :func:`opt_state_sharding` and
:func:`cache_sharding`'s T over ``model`` are rules only: ROADMAP queue
1 item 6, second half.
"""
from __future__ import annotations

from typing import Any

from repro_torch.core import sharding as _csh
from repro_torch.core.config import DoRAConfig
from repro_torch.core.sharding import P
from repro_torch.models import lm as _lm
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map

ROLE_PREFS: dict[str, tuple[tuple[str, ...], ...]] = {
    "tp": (("model",),),
    # Weight FSDP is pod-only by default; the data axis carries the batch.
    "fsdp": (("pod",),),
    # Models whose TP-sharded weights pass the per-chip budget shard d_in
    # over data too.
    "fsdp_data": (("pod", "data"), ("data",), ("pod",)),
    # Weights with no TP dim shard their d_out over (pod, data) and are
    # gathered before the product.
    "fsdp_gather": (("pod", "data"), ("data",), ("pod",)),
    "expert": (("pod", "data"), ("data",), ("pod",)),
    "repl": (),
}

# Per-chip weight budget above which d_in FSDP extends to the data axis.
_FSDP_DATA_THRESHOLD_BYTES = 6 * 2**30

DP_AXES = ("pod", "data")


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in DP_AXES if a in mesh.axis_names)


def pick_axes(size: int, role: str, mesh, used: set[str]) -> Any:
    """First preference whose axes all exist, don't collide with ``used``,
    and whose product divides ``size``. None = replicate this dim."""
    for axes in ROLE_PREFS.get(role, ()):
        axes = tuple(a for a in axes if a in mesh.axis_names)
        if not axes or any(a in used for a in axes):
            continue
        prod = 1
        for a in axes:
            prod *= mesh.shape[a]
        if size % prod == 0:
            used.update(axes)
            return axes if len(axes) > 1 else axes[0]
    return None


def spec_for(shape: tuple[int, ...], roles: tuple[str, ...], mesh) -> P:
    assert len(shape) == len(roles), (shape, roles)
    used: set[str] = set()
    return P(*(pick_axes(d, r, mesh, used) for d, r in zip(shape, roles)))


def _attn_tp_ok(mcfg: ModelConfig, mesh) -> tuple[bool, bool]:
    """(q sharded?, kv sharded?): heads must split the model axis."""
    tp = mesh.shape.get("model", 1)
    q_ok = mcfg.num_heads > 0 and mcfg.num_heads % tp == 0
    kv_ok = mcfg.num_kv_heads > 0 and mcfg.num_kv_heads % tp == 0
    return q_ok, kv_ok


def _fsdp_role(mcfg: ModelConfig, mesh) -> str:
    tp = dict(mesh.shape).get("model", 1)
    per_chip = mcfg.count_params() * 2 / max(tp, 1)  # bf16
    return "fsdp_data" if per_chip > _FSDP_DATA_THRESHOLD_BYTES else "fsdp"


def leaf_roles(mcfg: ModelConfig, name: str, ndim: int, mesh) \
        -> tuple[str, ...]:
    """Per-dim sharding roles for a (non-stacked) param leaf."""
    q_ok, kv_ok = _attn_tp_ok(mcfg, mesh)
    fsdp = _fsdp_role(mcfg, mesh)
    table: dict[str, tuple[str, ...]] = {
        "embed": ("tp", fsdp),
        "head": ("tp", fsdp),
        "wq": ("tp" if q_ok else "fsdp_gather",
               fsdp if q_ok else "repl"),
        "wk": ("tp" if kv_ok else "fsdp_gather",
               fsdp if kv_ok else "repl"),
        "wv": ("tp" if kv_ok else "fsdp_gather",
               fsdp if kv_ok else "repl"),
        "wo": ((fsdp, "tp") if q_ok else ("fsdp_gather", "repl")),
        "wq_bias": ("tp" if q_ok else "repl",),
        "wk_bias": ("tp" if kv_ok else "repl",),
        "wv_bias": ("tp" if kv_ok else "repl",),
        "w_gate": ("tp", fsdp),
        "w_up": ("tp", fsdp),
        "w_down": (fsdp, "tp"),
        "w_up_bias": ("tp",),
        "w_down_bias": ("repl",),
        "router": ("repl", "repl"),
        "gate": ("expert", "tp", fsdp),
        "up": ("expert", "tp", fsdp),
        "down": ("expert", fsdp, "tp"),
        "shared_gate": ("repl", "repl"),
        "in_proj": ("tp", fsdp),
        "out_proj": (fsdp, "tp"),
        "x_proj": ("repl", "tp"),
        "dt_proj": ("tp", "repl"),
        "dt_bias": ("tp",),
        "A_log": ("tp", "repl"),
        "skip_d": ("tp",),
        "conv_w": ("repl", "tp"),
        "conv_b": ("tp",),
    }
    if name in table:
        roles = table[name]
        assert len(roles) == ndim, (name, roles, ndim)
        return roles
    return ("repl",) * ndim


def param_sharding(mcfg: ModelConfig, mesh):
    """Spec tree matching ``models.lm.param_shapes(mcfg)``."""
    shapes = _lm.param_shapes(mcfg)

    def walk(tree, in_stack):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, in_stack or k == "stack")
            else:
                nd = len(v.shape) - (1 if in_stack else 0)
                roles = leaf_roles(mcfg, k, nd, mesh)
                if in_stack:
                    roles = ("repl",) + roles
                out[k] = spec_for(v.shape, roles, mesh)
        return out

    return walk(shapes, False)


def adapter_sharding(mcfg: ModelConfig, dcfg: DoRAConfig, mesh,
                     targets=_lm.DEFAULT_DORA_TARGETS, *,
                     serving: bool = False):
    """Spec tree matching ``models.lm.adapter_shapes``: A congruent with
    W's d_in, B/m with W's d_out, the rank dim replicated. ``serving``
    adds the serving-state leaves "g" (like m) and "gsB" (like B)."""
    shapes = _lm.adapter_shapes(mcfg, dcfg, targets)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) and "A" not in v:
                out[k] = walk(v)
                continue
            roles = leaf_roles(mcfg, k, 2, mesh)
            out[k] = {
                "A": spec_for(v["A"].shape, ("repl", "repl", roles[-1]),
                              mesh),
                "B": spec_for(v["B"].shape, ("repl", roles[0], "repl"),
                              mesh),
                "m": spec_for(v["m"].shape, ("repl", roles[0]), mesh),
            }
            if "base_sq" in v:
                out[k]["base_sq"] = spec_for(v["base_sq"].shape,
                                             ("repl", roles[0]), mesh)
            if serving:
                out[k]["g"] = spec_for(v["m"].shape, ("repl", roles[0]),
                                       mesh)
                out[k]["gsB"] = spec_for(v["B"].shape,
                                         ("repl", roles[0], "repl"), mesh)
        return out

    return {"stack": walk(shapes["stack"])}


def fleet_stack_sharding(adapter_shardings, mesh):
    """A fleet stack ([n_scan, K, ...]): the tenant axis 1 replicated,
    every other dim as the per-tenant serving spec."""
    def stackify(spec):
        spec = list(spec)
        spec.insert(1, None)
        return P(*spec)
    return tree_map(stackify, adapter_shardings)


def opt_state_sharding(adapter_shardings, mesh, adapter_shapes=None):
    """AdamW moments: the adapter spec plus ZeRO-1 sharding over ``data``
    on the largest still-replicated dim that divides it. A rule only: the
    port's step keeps the moments with their adapter shards (ROADMAP
    queue 1 item 6, second half)."""
    data = dict(mesh.shape).get("data", 1)

    def shard_moment(spec, sds):
        if adapter_shapes is None or data <= 1:
            return spec
        spec = list(spec) + [None] * (len(sds.shape) - len(spec))
        used = set()
        for e in spec:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a:
                    used.add(a)
        if "data" in used:
            return P(*spec)
        cands = [(d, i) for i, (d, e) in enumerate(zip(sds.shape, spec))
                 if e is None and d % data == 0]
        if not cands:
            return P(*spec)
        _, i = max(cands)
        spec[i] = "data"
        return P(*spec)

    if adapter_shapes is not None:
        moments = tree_map(shard_moment, adapter_shardings, adapter_shapes)
    else:
        moments = adapter_shardings
    return {"mu": moments, "nu": moments, "count": P()}


def _dp_entry(mesh, batch: int):
    """(pod, data) when the batch divides them, else replicated."""
    dp = dp_axes(mesh)
    size = 1
    for a in dp:
        size *= mesh.shape[a]
    if size == 0 or batch % size != 0:
        dp = ()
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def local_rows(mesh, batch: int) -> slice:
    """This data replica's rows of a batch laid out by :func:`batch_spec`:
    a block of ``batch / dp`` rows where :func:`_dp_entry` splits the
    batch, else every row (each replica holds the whole batch)."""
    axes = _csh._entry_axes(_dp_entry(mesh, batch))
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    i = mesh.axis_index(axes) if axes else 0
    return slice(i * batch // n, (i + 1) * batch // n)


def local_tenant_groups(mesh, batch: int, tenant_groups) -> tuple:
    """This data replica's share of a batch's static tenant groups: each
    whole-batch ``(start, size)`` group (``core/adapter.py
    check_tenant_groups``, at stack position k) cut to
    :func:`local_rows` and rebased to them, as ``(start, size, k)``; a
    group with no row here is dropped, and one that straddles two
    replicas keeps its position on both. The triples carry the position
    into the stacked tree, so the stack is never re-sliced. Where every
    replica holds the whole batch the groups come back as given."""
    from repro_torch.core.adapter import check_tenant_groups

    groups = check_tenant_groups(tenant_groups, batch)
    mine = local_rows(mesh, batch)
    if (mine.start, mine.stop) == (0, batch):
        return groups
    out = []
    for k, (start, size) in enumerate(groups):
        lo, hi = max(start, mine.start), min(start + size, mine.stop)
        if lo < hi:
            out.append((lo - mine.start, hi - lo, k))
    return tuple(out)


def local_adapter_idx(mesh, idx):
    """This data replica's rows of a whole-batch int [batch] tensor of
    per-row stack positions (the dynamic grouping's
    ``batch_in["adapter_idx"]``), cut by :func:`local_rows` as the
    tokens are: the positions themselves index the whole K-stack, so
    they are kept as they are."""
    return idx[local_rows(mesh, idx.shape[0])]


def batch_spec(mesh, *, batch: int) -> P:
    return P(_dp_entry(mesh, batch), None)


def activation_spec(mesh, *, batch: int, seq: int) -> P:
    """[B, S, D] activations: batch over dp, sequence over model (SP)."""
    bdim = _dp_entry(mesh, batch)
    tp = dict(mesh.shape).get("model", 1)
    sdim = "model" if seq % tp == 0 and seq > 1 else None
    return P(bdim, sdim, None)


def row_parallel_b_axes(mcfg: ModelConfig, mesh) -> tuple[str, ...]:
    """Mesh axes sharding the d_out of the row-parallel adapted weights
    (wo / w_down) beyond the output's feature axes; () when the two
    weights disagree; size-1 axes dropped."""
    per_weight = []
    for name in ("wo", "w_down"):
        role = leaf_roles(mcfg, name, 2, mesh)[0]
        axes = pick_axes(mcfg.d_model, role, mesh, set())
        if axes is None:
            axes = ()
        elif not isinstance(axes, tuple):
            axes = (axes,)
        per_weight.append(tuple(a for a in axes if mesh.shape[a] > 1))
    if per_weight[0] != per_weight[1]:
        return ()
    return per_weight[0]


def make_boundary_constraint(mesh, *, batch: int, seq: int,
                             b_dout_axes: tuple[str, ...] = (),
                             decode: bool = False):
    """The layout of [B, S, D] activations
    (:class:`~repro_torch.core.sharding.SequenceParallel`); ``.plan`` is
    the reference's compose plan for it, ``b_dout_axes`` threaded in.
    ``decode``: the tensor-parallel mode with the sequence whole on every
    rank, for the decode and draft steps' S = 1 and the speculative
    verify's window of S = k + 1: each row's frontier and its K/V writes
    need the whole window on every rank, so the spec leaves the sequence
    unsplit whatever S is."""
    spec = (P(_dp_entry(mesh, batch), None, None) if decode
            else activation_spec(mesh, batch=batch, seq=seq))
    plan = _csh.plan_for_output(mesh, spec, b_dout_axes=tuple(b_dout_axes))
    return _csh.SequenceParallel(mesh, spec, plan, seq_split=not decode)


def cache_sharding(mcfg: ModelConfig, mesh, *, batch: int,
                   block_size: int | None = None):
    """Decode cache specs, the reference's rule: KV [n_scan, B, T, Hkv,
    hd] batch over dp, seq over model; Mamba h and conv d_inner over
    model; a paged pool's in-block seq over model when it divides.

    The rule is GSPMD's storage layout, not what the port's runtime
    holds: under a mesh the prefill, decode and engine steps lay K/V out
    by heads, each rank keeping the K/V of its own ``Hkv / tp`` heads for
    its data replica's rows (``models/lm.py cache_shapes(mesh=)``; a
    paged pool whole on every replica, as this rule keeps it), so
    attention needs no collective. Every mesh the runtime accepts can do
    so: ``launch/steps.py mesh_layout`` refuses ``fsdp_gather``, so
    ``num_kv_heads % tp == 0`` holds. T over model returns with the pod
    axis's ``fsdp_gather`` layouts (ROADMAP queue 1 item 6, second half,
    point 2)."""
    b_ax = _dp_entry(mesh, batch)
    tp = dict(mesh.shape).get("model", 1)
    kinds = mcfg.layer_kinds()
    unit: dict[str, Any] = {}
    for i in range(mcfg.period):
        if kinds[i] == "attn":
            if block_size is not None:
                bs_ax = "model" if tp > 1 and block_size % tp == 0 \
                    else None
                kv = P(None, None, bs_ax, None, None)
            else:
                kv = P(None, b_ax, "model", None, None)
            unit[f"l{i}"] = {"k": kv, "v": kv}
        else:
            di_ok = mcfg.d_inner % tp == 0
            unit[f"l{i}"] = {
                "h": P(None, b_ax, "model" if di_ok else None, None),
                "conv": P(None, b_ax, None, "model" if di_ok else None)}
    out = {"stack": unit, "len": P()}
    if block_size is not None:
        out["pages"] = P()
    return out


# ---------------------------------------------------------------------------
# Placing trees on a mesh of ranks.
# ---------------------------------------------------------------------------

def shard_tree(full_tree, spec_tree, mesh):
    """This rank's slices of a full tree laid out by ``spec_tree``: fresh
    tensors, so an in-place update of a shard leaves the full tree as it
    was. A leaf whose spec is missing is refused."""
    def cut(leaf, spec):
        out = leaf
        spec = tuple(spec)
        for dim, entry in enumerate(spec):
            axes = _csh._entry_axes(entry)
            n = mesh.axis_size(axes) if axes else 1
            if n == 1:
                continue
            if out.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(out.shape)} does not "
                                 f"split over {entry!r}")
            step = out.shape[dim] // n
            out = out.narrow(dim, mesh.axis_index(axes) * step, step)
        return out.detach().clone()
    return tree_map(cut, full_tree, spec_tree)


def unshard_tree(local_tree, spec_tree, mesh, *, tag: str = "unshard"):
    """The full tree back from every rank's slices (all-gathers built on
    ``all_reduce``); replicated leaves as they are."""
    def gather(leaf, spec):
        out = leaf
        for dim, entry in enumerate(tuple(spec)):
            axes = _csh._entry_axes(entry)
            if axes and mesh.axis_size(axes) > 1:
                out = _csh.all_gather(out.contiguous(), axes, mesh, dim,
                                      tag=tag)
        return out
    return tree_map(gather, local_tree, spec_tree)
