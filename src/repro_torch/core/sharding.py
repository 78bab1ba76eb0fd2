"""Sharding plans of the compose and the collectives they need
(counterpart of ``repro/core/sharding.py``).

:class:`ComposeSharding` is the reference's per-call-site plan, kept
field for field: for an output ``y [..., d_out]`` with spec
``out_spec``, the rank-space ``h = x·Aᵀ`` shards its rows like ``y`` and
replicates r, and B, g and m shard congruent with ``d_out``. The compose
kernels then run on each rank's ``[rows_local, d_out_local]`` tile
(:func:`repro_torch.kernels.ops.fused_compose_mm`): the forward needs no
collective, the backward sums d_h over the d_out axes and T = dYᵀ·h and
d_g's base term over the row axes.

A spec is a tuple with one entry per dim: None, an axis name, or a
tuple of axis names (:class:`PartitionSpec`), as the reference's
``PartitionSpec`` reads. There is no GSPMD here: tensors are each
rank's local shards, and the plan's ``constrain`` methods check that a
shard's shape agrees with the plan instead of placing it.

The collectives (:func:`psum`, :func:`pmax`, :func:`all_gather`,
:func:`reduce_scatter`) are all built on ``all_reduce``, which gloo runs
on CUDA tensors and NCCL across cards: an all-gather writes the local
shard into a zeroed buffer and sums it (exact: every other addend is
zero); a reduce-scatter is an all-reduce and the local slice. Each call
adds to a module-level count of calls and bytes under its tag
(:func:`collective_stats`). The autograd pairs of the sequence-parallel
layout are :func:`gather_rows` (all-gather forward, reduce-scatter
backward), :func:`scatter_rows` (the reverse) and :func:`grad_psum`
(identity forward, the gradient summed); :class:`SequenceParallel` is
the layout the layers run under a mesh, sequence-parallel (train step,
prefill) or tensor-parallel with the sequence whole (decode).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any

import torch
import torch.distributed as dist

_F32 = torch.float32


class PartitionSpec(tuple):
    """One entry per dim: None, an axis name or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _entry_axes(entry) -> tuple[str, ...]:
    """Mesh axes named by one spec entry (None → ())."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def _axes_size(mesh, axes: tuple[str, ...]) -> int:
    size = 1
    shape = dict(mesh.shape)
    for a in axes:
        size *= shape[a]
    return size


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The shard of a ``shape`` tensor laid out by ``spec`` on ``mesh``;
    a dim its axes do not divide raises."""
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for d, entry in zip(shape, spec):
        n = _axes_size(mesh, _entry_axes(entry))
        if d % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {entry!r} ({n} ranks)")
        out.append(d // n)
    return tuple(out)


# ---------------------------------------------------------------------------
# Collectives, all from all_reduce.
# ---------------------------------------------------------------------------

_STATS: dict[str, dict[str, int]] = defaultdict(
    lambda: {"calls": 0, "bytes": 0})


def collective_stats() -> dict[str, dict[str, int]]:
    """{tag: {"calls", "bytes"}} since the last reset: one call and the
    reduced tensor's bytes per ``all_reduce``."""
    return {k: dict(v) for k, v in _STATS.items()}


def reset_collective_stats() -> None:
    _STATS.clear()


def _all_reduce(t, group, tag: str, op=dist.ReduceOp.SUM):
    dist.all_reduce(t, op=op, group=group)
    st = _STATS[tag]
    st["calls"] += 1
    st["bytes"] += t.numel() * t.element_size()
    return t


def psum(x, axes, mesh, *, tag: str = "psum"):
    """Σ of ``x`` over the ranks along ``axes``: a new tensor (x is left
    as it is); ``x`` itself when the axes hold one rank."""
    group = mesh.group(axes)
    if group is None:
        return x
    return _all_reduce(x.detach().contiguous().clone(), group, tag)


def pmax(x, axes, mesh, *, tag: str = "pmax"):
    """Elementwise max of ``x`` over the ranks along ``axes``."""
    group = mesh.group(axes)
    if group is None:
        return x
    return _all_reduce(x.detach().contiguous().clone(), group, tag,
                       op=dist.ReduceOp.MAX)


def all_gather(x, axes, mesh, dim: int, *, tag: str = "all_gather"):
    """The shards of ``x`` along ``axes`` concatenated on ``dim`` in the
    axes' row-major order."""
    group = mesh.group(axes)
    if group is None:
        return x
    n, i = mesh.axis_size(axes), mesh.axis_index(axes)
    shape = list(x.shape)
    step = shape[dim]
    shape[dim] *= n
    buf = x.new_zeros(shape)
    buf.narrow(dim, i * step, step).copy_(x)
    return _all_reduce(buf, group, tag)


def reduce_scatter(x, axes, mesh, dim: int, *, tag: str = "reduce_scatter"):
    """Σ of ``x`` over the ranks along ``axes``, then this rank's slice of
    ``dim``."""
    group = mesh.group(axes)
    if group is None:
        return x
    n, i = mesh.axis_size(axes), mesh.axis_index(axes)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    step = x.shape[dim] // n
    y = _all_reduce(x.detach().contiguous().clone(), group, tag)
    return y.narrow(dim, i * step, step).contiguous()


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim, tag):
        ctx.args = (axes, mesh, dim, tag)
        return all_gather(x, axes, mesh, dim, tag=tag)

    @staticmethod
    def backward(ctx, g):
        axes, mesh, dim, tag = ctx.args
        return (reduce_scatter(g, axes, mesh, dim, tag=tag + ".bwd"),
                None, None, None, None)


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim, tag):
        ctx.args = (axes, mesh, dim, tag)
        return reduce_scatter(x, axes, mesh, dim, tag=tag)

    @staticmethod
    def backward(ctx, g):
        axes, mesh, dim, tag = ctx.args
        return (all_gather(g.contiguous(), axes, mesh, dim,
                           tag=tag + ".bwd"), None, None, None, None)


class _GradPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, tag):
        ctx.args = (axes, mesh, tag)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        axes, mesh, tag = ctx.args
        return psum(g, axes, mesh, tag=tag), None, None, None


def _mm_f32(x, w):
    """x [..., k] · wᵀ ([n, k]) with the fp32 sums kept: on the card a
    bf16/fp16 product on the tensor cores that writes its fp32
    accumulators (``torch.mm(out_dtype=)``); on the CPU the exact
    products of the upcast operands, summed in fp32."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda:
        y = torch.mm(x2, w.T, out_dtype=_F32)
    else:
        y = x2.to(_F32) @ w.to(_F32).T
    return y.reshape(*x.shape[:-1], w.shape[0])


class _PartialProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ w if ctx.needs_input_grad[0] else None
        gw = (g.reshape(-1, g.shape[-1]).T @ x.reshape(-1, x.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return gx, gw


def partial_product(x, w):
    """x·wᵀ of a rank's d_in shards, a partial sum that the ranks add up:
    in fp32 (the product's own accumulators, not rounded to x's dtype),
    so that the sum across ranks is rounded once, as one card's product
    is. fp32 operands take the plain product. The gradients are the plain
    product's, in x's dtype."""
    if x.dtype == _F32:
        return x @ w.T
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _PartialProduct.apply(x, w)
    return _mm_f32(x, w)


def gather_rows(x, axes, mesh, dim: int = 1, *, tag: str = "sp.gather"):
    """All-gather ``dim`` forward; reduce-scatter of the gradient."""
    if mesh.group(axes) is None:
        return x
    return _GatherRows.apply(x, axes, mesh, dim, tag)


def scatter_rows(x, axes, mesh, dim: int = 1, *, tag: str = "sp.scatter"):
    """Reduce-scatter of ``dim`` forward; all-gather of the gradient."""
    if mesh.group(axes) is None:
        return x
    return _ScatterRows.apply(x, axes, mesh, dim, tag)


def grad_psum(x, axes, mesh, *, tag: str = "grad.psum"):
    """Identity forward; the gradient summed over ``axes``: a leaf
    replicated over those ranks whose each rank's gradient is a part."""
    if mesh.group(axes) is None:
        return x
    return _GradPsum.apply(x, axes, mesh, tag)


# ---------------------------------------------------------------------------
# The compose plan.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ComposeSharding:
    """Sharding plan for one adapted-linear call site.

    ``out_spec`` is the spec of the module output ``y [..., d_out]``; the
    spec of h, B, g, the flattened kernel view and the backward's
    collective axes derive from it. ``b_dout_axes``: mesh axes sharding
    B's (and g/m's) d_out beyond the output's own feature axes; such a
    plan is inexpressible for the shard-local kernels.

    ``psum_dh`` (the port's): False where the caller reduces d_h's
    per-rank partial another way. A column-parallel module behind the
    sequence all-gather does: its input's gradient is reduce-scattered
    by the gather's backward, which needs each rank's part, and A's
    gradient is summed over the model axis (:func:`grad_psum`).
    """

    mesh: Any
    out_spec: tuple
    b_dout_axes: tuple[str, ...] = ()
    psum_dh: bool = True

    # -- derived specs ------------------------------------------------------

    @property
    def row_axes(self) -> tuple[str, ...]:
        """Mesh axes sharding the (flattened) row dims, in dim order."""
        axes: list[str] = []
        for entry in tuple(self.out_spec)[:-1]:
            axes.extend(_entry_axes(entry))
        return tuple(axes)

    @property
    def dout_axes(self) -> tuple[str, ...]:
        """Mesh axes sharding the d_out (feature) dim."""
        spec = tuple(self.out_spec)
        return _entry_axes(spec[-1]) if spec else ()

    @property
    def dout_shards(self) -> int:
        return _axes_size(self.mesh, self.dout_axes)

    @property
    def row_shards(self) -> int:
        return _axes_size(self.mesh, self.row_axes)

    @property
    def h_spec(self) -> PartitionSpec:
        """Rows like the output, the rank dim replicated."""
        return P(*(tuple(self.out_spec)[:-1] + (None,)))

    def _b_dout_entry(self):
        axes = self.dout_axes + tuple(
            a for a in self.b_dout_axes if a not in self.dout_axes)
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]

    @property
    def b_spec(self) -> PartitionSpec:
        return P(self._b_dout_entry(), None)

    @property
    def vec_spec(self) -> PartitionSpec:
        return P(self._b_dout_entry())

    def flat2d(self) -> tuple[Any, Any]:
        """(row_entry, dout_entry) of the flattened [M, d_out] view."""
        row = self.row_axes
        spec = tuple(self.out_spec)
        return (row if len(row) > 1 else (row[0] if row else None),
                spec[-1] if spec else None)

    # -- expressibility -----------------------------------------------------

    def local_dout(self, d_out: int) -> int:
        return d_out // max(self.dout_shards, 1)

    def kernel_expressible(self, d_out: int) -> bool:
        """The local d_out shard even and a multiple of 128, and B
        congruent with the output's d_out."""
        if any(a not in self.dout_axes for a in self.b_dout_axes):
            return False
        shards = self.dout_shards
        return d_out % max(shards, 1) == 0 and \
            self.local_dout(d_out) % 128 == 0

    # -- shape checks (the port's counterpart of the constraints) -----------

    def _constrain(self, x, spec, global_shape=None):
        if len(spec) > x.ndim:
            raise ValueError(
                f"ComposeSharding built for a rank-{len(self.out_spec)} "
                f"output cannot constrain a rank-{x.ndim} tensor "
                f"(spec {spec})")
        if global_shape is not None:
            want = local_shape(tuple(global_shape), spec, self.mesh)
            if tuple(x.shape) != want:
                raise ValueError(
                    f"local shard {tuple(x.shape)} does not agree with "
                    f"{tuple(global_shape)} laid out by {spec}: want "
                    f"{want}")
        return x

    def __call__(self, y, global_shape=None):
        return self._constrain(y, self.out_spec, global_shape)

    def constrain_h(self, h, global_shape=None):
        return self._constrain(h, self.h_spec, global_shape)

    def constrain_vec(self, v, global_shape=None):
        return self._constrain(v, self.vec_spec, global_shape)

    def constrain_b(self, b, global_shape=None):
        if b.ndim != 2:
            raise ValueError(
                f"constrain_b expects an unstacked [d_out, r] weight, got "
                f"rank-{b.ndim}")
        return self._constrain(b, self.b_spec, global_shape)


def plan_for_output(mesh, out_spec, b_dout_axes: tuple[str, ...] = (),
                    *, psum_dh: bool = True) -> ComposeSharding:
    """The compose plan of a module whose output carries ``out_spec``."""
    return ComposeSharding(mesh, P(*tuple(out_spec)),
                           b_dout_axes=tuple(b_dout_axes), psum_dh=psum_dh)


def as_compose_sharding(constrain) -> ComposeSharding | None:
    """The plan of a ``constrain`` argument: a :class:`ComposeSharding`,
    or an object carrying one as ``.plan``; None otherwise."""
    if constrain is None:
        return None
    if isinstance(constrain, ComposeSharding):
        return constrain
    plan = getattr(constrain, "plan", None)
    if isinstance(plan, ComposeSharding):
        return plan
    return None


# ---------------------------------------------------------------------------
# The sequence-parallel layout of the layers.
# ---------------------------------------------------------------------------

COLUMN_PARALLEL = ("wq", "wk", "wv", "w_gate", "w_up")
ROW_PARALLEL = ("wo", "w_down")


@dataclasses.dataclass(frozen=True, eq=False)
class SequenceParallel:
    """The explicit form of the reference's boundary constraint
    (``repro/launch/sharding.py:364 make_boundary_constraint``), in one of
    two modes that share the layer code and differ only in collectives.

    Sequence-parallel (``seq_split``, the train step and the prefill):
    each data replica runs its own batch rows; inside it the residual
    stream is split along the sequence over ``axis`` ([B, S/tp, D] a
    rank). Column-parallel modules (:data:`COLUMN_PARALLEL`) take the
    all-gathered rows and their local rows of W; row-parallel ones
    (:data:`ROW_PARALLEL`) take their local columns of W and
    reduce-scatter y_base and h back to the sequence split, with the
    norm summed over ``axis``.

    Tensor-parallel with no sequence split (``seq_split=False``, the
    decode and draft steps, whose S = 1 the axis cannot split, and the
    speculative verify, whose k + 1 window every rank needs whole for
    its rows' frontiers and K/V writes; forward only; any S): the
    residual stream is whole on every rank of ``axis``, so the gather is
    the identity, and the row-parallel modules all-reduce y_base and h
    over ``axis`` before the compose.

    In both modes the row-parallel partials are fp32
    (:func:`partial_product`) and rounded to the activation dtype after
    the sum, once, as one card rounds its product.
    Column-parallel modules run on their local rows as in the other
    mode.

    ``spec`` and ``plan`` are the reference's (rows over the data axes
    and, sequence-parallel, ``axis``); ``row_plan`` and ``col_plan`` are
    what the layers run inside a replica, whose data axes the train
    step's gradient all-reduce covers. Collective tags carry the mode's
    prefix ("sp." or "tp.")."""
    mesh: Any
    spec: tuple
    plan: ComposeSharding
    axis: str = "model"
    seq_split: bool = True

    @property
    def tp(self) -> int:
        return dict(self.mesh.shape).get(self.axis, 1)

    @property
    def prefix(self) -> str:
        return "sp" if self.seq_split else "tp"

    @property
    def row_plan(self) -> ComposeSharding:
        """Row-parallel modules: d_out whole, rows (the sequence) over
        ``axis`` when it is split."""
        return plan_for_output(
            self.mesh, P(None, self.axis if self.seq_split else None, None))

    @property
    def col_plan(self) -> ComposeSharding:
        """Column-parallel modules: d_out over ``axis``; d_h's partial is
        reduced by the gather's backward and A's gradient sum."""
        return plan_for_output(self.mesh, P(None, None, self.axis),
                               psum_dh=False)

    def gather(self, x, *, tag: str = "gather"):
        """[B, S/tp, ...] → [B, S, ...]; the identity with no split."""
        if not self.seq_split:
            return x
        return gather_rows(x, (self.axis,), self.mesh, 1,
                           tag=f"{self.prefix}.{tag}")

    def scatter(self, x, *, tag: str = "scatter"):
        """[B, S, ...] partial sums → [B, S/tp, ...] summed; with no split,
        [B, S, ...] summed over ``axis``. In x's dtype: the row-parallel
        projections hand in fp32 partials (:func:`partial_product`)."""
        if self.seq_split:
            return scatter_rows(x, (self.axis,), self.mesh, 1,
                                tag=f"{self.prefix}.{tag}")
        if self.mesh.group((self.axis,)) is None:
            return x
        return psum(x, (self.axis,), self.mesh, tag=f"{self.prefix}.{tag}")

    def partial(self, x, w):
        """A row-parallel module's x·wᵀ over this rank's d_in shard:
        :func:`partial_product` (fp32) when ``axis`` splits d_in, the
        plain product when it holds one rank."""
        if self.tp == 1:
            return x @ w.T
        return partial_product(x, w)

    def local_rows(self, x, dim: int = 1):
        """This rank's slice of a replicated [B, S, ...] tensor: all of it
        with no split."""
        n = self.tp
        if n == 1 or not self.seq_split:
            return x
        step = x.shape[dim] // n
        return x.narrow(dim, self.mesh.axis_index(self.axis) * step, step)

    def reduce_grad(self, x, *, tag: str = "grad.col_A"):
        return grad_psum(x, (self.axis,), self.mesh, tag=tag)

    def norm_axis(self, name: str) -> str | None:
        """The axis a module's norm partials sum over: ``axis`` for the
        row-parallel modules when it splits W's d_in (more than one
        rank), None otherwise."""
        return self.axis if name in ROW_PARALLEL and self.tp > 1 else None
