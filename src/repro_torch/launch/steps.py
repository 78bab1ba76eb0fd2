"""Step functions (counterpart of ``repro/launch/steps.py``): the train
step, and the serving steps precompute, padded prefill, decode, and the
continuous-batching engine's prefill-into-slot, prefill-chunk, and the
speculative draft and verify.

Each ``make_*_step`` returns a plain function over (params, adapters,
...). Given a mesh (``launch/mesh.py``), the train, grad, precompute,
prefill, decode, engine admission, draft and verify steps run on this
rank's shards (``launch/sharding.py shard_tree``): the batch rows of its
data replica, tensor parallelism over ``model`` with the sequence split
between blocks (the decode and draft steps' S = 1 and the verify's k + 1
window: whole), the vocab-parallel head and its
parallel cross entropy; the adapter gradients are averaged over the data axes in fp32
and the clip's global norm is summed over the shards. The
train step updates the adapters and the optimizer state IN PLACE and
returns the same trees. The decode cache is updated IN PLACE: the K/V
buffers the prefill allocates are the ones every decode step writes, and
the cache dict a step returns holds those same buffers with "len"
advanced.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core import sharding as _sh
from repro_torch.core.adapter import precompute_adapter_state
from repro_torch.core.config import DoRAConfig
from repro_torch.launch.mesh import axis_size
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import (adapter_shapes, check_mesh_supported,
                                   forward, init_cache)
from repro_torch.optim.adamw import OptimizerConfig, adamw_update
from repro_torch.tree import flatten_paths, tree_map, unflatten_paths

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Everything the step builders need beyond the model config."""
    dora: DoRAConfig = DoRAConfig(rank=384, alpha=192.0, mode="auto")
    optim: OptimizerConfig = OptimizerConfig()
    # paper §5.1: partial-sequence loss (1024 tokens) matches production
    # RLHF memory profiles and avoids the full-seq logit spike.
    loss_tokens: int | None = None
    grad_accum: int = 1


class PhaseClock:
    """Wall time of each phase of a step into ``stats`` (seconds),
    measured between device synchronisations; does nothing when ``stats``
    is None, so an untimed run never synchronises."""

    def __init__(self, stats: dict | None, device: torch.device):
        self.stats = stats
        self.device = torch.device(device)
        self.t0 = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        if self.stats is not None:
            self._sync()
            self.t0 = time.perf_counter()

    def stop(self, name: str):
        if self.stats is not None:
            self._sync()
            self.stats[name] = time.perf_counter() - self.t0


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels):
    """Mean token NLL with an fp32 logsumexp."""
    logits32 = logits.to(_F32)
    lse = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


class _VocabParallelCE(torch.autograd.Function):
    """Mean token NLL over logits split along the vocab: the max, the sum
    of exps and the target logit are each summed (the max: reduced by
    max) over the vocab axis, so every rank of a replica holds the same
    loss; the gradient is this rank's columns of softmax − one-hot."""

    @staticmethod
    def forward(ctx, logits, labels, sp):
        l32 = logits.to(_F32)
        v_local = l32.shape[-1]
        mx = _sh.pmax(l32.amax(dim=-1), (sp.axis,), sp.mesh, tag="ce.max")
        ex = torch.exp(l32 - mx[..., None])
        se = _sh.psum(ex.sum(dim=-1), (sp.axis,), sp.mesh, tag="ce.sumexp")
        local = labels.long() - sp.mesh.axis_index(sp.axis) * v_local
        hit = (local >= 0) & (local < v_local)
        idx = local.clamp(0, v_local - 1)[..., None]
        gold = torch.where(hit, torch.gather(l32, -1, idx)[..., 0],
                           torch.zeros_like(mx))
        gold = _sh.psum(gold, (sp.axis,), sp.mesh, tag="ce.target")
        nll = torch.log(se) + mx - gold
        ctx.save_for_backward(ex, se, idx, hit)
        ctx.dtype = logits.dtype
        return nll.mean()

    @staticmethod
    def backward(ctx, g):
        ex, se, idx, hit = ctx.saved_tensors
        grad = ex / se[..., None]
        grad.scatter_add_(-1, idx, -hit.to(_F32)[..., None])
        grad = grad * (g / (se.numel()))
        return grad.to(ctx.dtype), None, None


def vocab_parallel_cross_entropy(logits, labels, sp):
    """:func:`cross_entropy` of logits [B, S, V/tp] split along the vocab
    over ``sp.axis`` (the reference's V-sharded loss under SPMD)."""
    if dict(sp.mesh.shape).get(sp.axis, 1) == 1:
        return cross_entropy(logits, labels)
    return _VocabParallelCE.apply(logits, labels, sp)


@dataclasses.dataclass(frozen=True, eq=False)
class MeshLayout:
    """What a step under a mesh needs: the sequence-parallel layout, the
    data axes and this rank's batch rows, and the adapter spec tree (for
    the clip's norm across shards)."""
    mesh: object
    sp: _sh.SequenceParallel
    dp_axes: tuple
    local_batch: int
    adapter_specs: dict

    @property
    def dp_size(self) -> int:
        return axis_size(self.mesh, *self.dp_axes)

    def mean_over_data(self, grads):
        """fp32 mean of each gradient over the data axes."""
        if self.dp_size == 1:
            return grads
        return tree_map(lambda g: _sh.psum(
            g.to(_F32), self.dp_axes, self.mesh, tag="grad.dp")
            / self.dp_size, grads)

    def global_norm(self, grads):
        """sqrt of the summed squares of the whole (unsharded) tree: the
        squares of the leaves split over ``model`` are summed over it,
        the replicated ones counted once."""
        specs = flatten_paths(self.adapter_specs)
        zero = torch.zeros((), dtype=_F32)
        rep = shd = None
        for name, g in flatten_paths(grads).items():
            sq = g.to(_F32).square().sum()
            axes = [a for e in specs[name] for a in _sh._entry_axes(e)]
            if self.sp.axis in axes:
                shd = sq if shd is None else shd + sq
            else:
                rep = sq if rep is None else rep + sq
        dev = next(iter(flatten_paths(grads).values())).device
        rep = zero.to(dev) if rep is None else rep
        shd = zero.to(dev) if shd is None else shd
        shd = _sh.psum(shd, (self.sp.axis,), self.mesh, tag="grad.norm")
        return torch.sqrt(rep + shd)


def _mesh_rules(mcfg: ModelConfig, scfg: StepConfig, mesh) -> dict:
    """The spec trees of the params and adapters on ``mesh``, after
    checking that the runtime honours them. Refused (ROADMAP queue 1 item
    6, second half): a pod axis, any weight whose spec names an axis
    other than ``model`` (FSDP, ``fsdp_gather``, experts) and non-dense
    stacks."""
    from repro_torch.launch import sharding as S

    check_mesh_supported(mcfg)
    if "pod" in mesh.axis_names:
        raise NotImplementedError(
            "the pod axis (FSDP gathers, compression on the wire) is "
            "ROADMAP queue 1 item 6, second half, point 2")
    specs = {"params": S.param_sharding(mcfg, mesh),
             "adapters": S.adapter_sharding(mcfg, scfg.dora, mesh)}
    for name, spec in flatten_paths(specs).items():
        axes = {a for e in spec for a in _sh._entry_axes(e)}
        if axes - {"model"}:
            raise NotImplementedError(
                f"{mcfg.name} on mesh {dict(mesh.shape)}: {name} is laid "
                f"out {tuple(spec)}; FSDP and gathered layouts are "
                f"ROADMAP queue 1 item 6, second half, point 2")
    return specs


def mesh_layout(mcfg: ModelConfig, scfg: StepConfig, mesh, *, batch: int,
                seq: int, decode: bool = False) -> MeshLayout:
    """Check that the runtime honours the rules on ``mesh``
    (:func:`_mesh_rules`) and return the layout: sequence-parallel, which
    refuses a sequence the model axis does not split, or with ``decode``
    the tensor-parallel layout with the sequence whole, which takes
    S = 1 only."""
    from repro_torch.launch import sharding as S

    specs = _mesh_rules(mcfg, scfg, mesh)
    tp = dict(mesh.shape).get("model", 1)
    if not decode and seq % tp:
        raise ValueError(f"seq {seq} does not split over model={tp}")
    sp = S.make_boundary_constraint(mesh, batch=batch, seq=seq,
                                    decode=decode)
    entry = S.batch_spec(mesh, batch=batch)[0]
    dp = _sh._entry_axes(entry)
    return MeshLayout(mesh, sp, dp, batch // axis_size(mesh, *dp),
                      specs["adapters"])


def _inputs(batch_in) -> dict:
    """The forward's input from a batch: {"embeds": ...} when the batch
    carries a frontend's precomputed embeddings, else {"tokens": ...}."""
    if "embeds" in batch_in:
        return {"embeds": batch_in["embeds"]}
    return {"tokens": batch_in["tokens"]}


def make_grad_step(mcfg: ModelConfig, scfg: StepConfig, mesh=None, *,
                   batch: int, seq: int):
    """(params, adapters, batch_in) -> (loss, grads): the train step
    without its optimizer update.

    ``batch_in``: {"tokens", "labels"} int [batch, seq], or {"embeds",
    "labels"} with a frontend's embeddings [batch, seq, d_model] in place
    of the tokens. ``grads`` has the
    adapter tree's structure; the frozen base params get no gradient.
    ``scfg.loss_tokens``: the loss reads only the last N positions (the
    head runs on those alone). ``scfg.grad_accum`` = ga: the batch is
    split into ga microbatches along its first dim, their gradients
    summed in fp32 and divided by ga, as the reference's scan does. The
    loss is the token-mean cross entropy plus the MoE layers' router loss
    (zero without MoE or with ``router_aux_coef`` 0).

    ``mesh``: params, adapters and batch are this rank's shards (the
    batch rows [batch / data, seq]); the loss is the replica's (the same
    on every rank of it) averaged over the data axes, and so are the
    gradients, which are this rank's adapter shards."""
    lt = scfg.loss_tokens
    ga = max(scfg.grad_accum, 1)
    lay = None if mesh is None else mesh_layout(mcfg, scfg, mesh,
                                                batch=batch, seq=seq)
    rows = batch if lay is None else lay.local_batch
    if rows % ga:
        raise ValueError(f"batch {rows} is not divisible by grad_accum "
                         f"{ga}")
    sp = None if lay is None else lay.sp

    def loss_fn(params, adapters, inputs, labels):
        logits, _, aux = forward(mcfg, params, adapters, scfg.dora,
                                 **inputs, training=True, loss_slice=lt,
                                 return_aux=True, boundary_constraint=sp)
        lbl = labels if lt is None or lt >= labels.shape[1] \
            else labels[:, -lt:]
        if sp is not None:
            return vocab_parallel_cross_entropy(logits, lbl, sp) + aux
        return cross_entropy(logits, lbl) + aux

    def value_and_grad(params, adapters, inputs, labels):
        leaves = flatten_paths(adapters)
        was = {name: leaf.requires_grad for name, leaf in leaves.items()}
        try:
            for leaf in leaves.values():
                leaf.requires_grad_(True)
            with torch.enable_grad():
                loss = loss_fn(params, adapters, inputs, labels)
                grads = torch.autograd.grad(loss, list(leaves.values()),
                                            allow_unused=True)
        finally:
            for name, leaf in leaves.items():
                leaf.requires_grad_(was[name])
        # Leaves the loss does not reach (the frozen base_sq) get zeros,
        # as jax.grad gives them.
        return loss.detach(), unflatten_paths({
            name: torch.zeros_like(leaf) if g is None else g
            for (name, leaf), g in zip(leaves.items(), grads)})

    def accumulate(params, adapters, batch_in):
        inputs, labels = _inputs(batch_in), batch_in["labels"]
        (name, x), = inputs.items()
        if tuple(x.shape[:2]) != (rows, seq) \
                or tuple(labels.shape) != (rows, seq):
            raise ValueError(f"step built for [{rows}, {seq}] {name} and "
                             f"labels, got {tuple(x.shape)} and "
                             f"{tuple(labels.shape)}")
        if ga == 1:
            return value_and_grad(params, adapters, inputs, labels)
        mb = rows // ga
        loss = torch.zeros((), dtype=_F32, device=x.device)
        grads = tree_map(lambda a: torch.zeros(a.shape, dtype=_F32,
                                               device=a.device), adapters)
        for i in range(ga):
            sl = slice(i * mb, (i + 1) * mb)
            loss_i, g_i = value_and_grad(params, adapters,
                                         {name: x[sl]}, labels[sl])
            loss = loss + loss_i
            tree_map(lambda acc, g: acc.add_(g), grads, g_i)
        return loss / ga, tree_map(lambda g: g / ga, grads)

    def grad_step(params, adapters, batch_in):
        loss, grads = accumulate(params, adapters, batch_in)
        if lay is None or lay.dp_size == 1:
            return loss, grads
        loss = _sh.psum(loss.to(_F32), lay.dp_axes, lay.mesh,
                        tag="loss.dp") / lay.dp_size
        return loss, lay.mean_over_data(grads)

    grad_step.layout = lay
    return grad_step


def make_train_step(mcfg: ModelConfig, scfg: StepConfig, mesh=None, *,
                    batch: int, seq: int):
    """(params, adapters, opt_state, batch_in, stats=None) -> (adapters',
    opt_state', metrics): :func:`make_grad_step`, then AdamW.

    The adapters and the AdamW state are updated in place (the returned
    trees are the ones given). ``metrics``: {"loss", "grad_norm"} fp32 0-d
    tensors and the float "lr". ``stats``: when given, filled with the
    wall seconds of the forward+backward (``grad_s``) and of the optimizer
    (``optim_s``), each ended by a device synchronisation.

    ``mesh``: as :func:`make_grad_step`; AdamW keeps each rank's moments
    beside its adapter shards (``launch/sharding.py opt_state_sharding``'s
    ZeRO-1 layout is not honoured yet) and clips by the global norm of
    the whole tree."""
    grad_step = make_grad_step(mcfg, scfg, mesh, batch=batch, seq=seq)
    lay = grad_step.layout

    def train_step(params, adapters, opt_state, batch_in, stats=None):
        clock = PhaseClock(stats, batch_in["labels"].device)
        clock.start()
        loss, grads = grad_step(params, adapters, batch_in)
        clock.stop("grad_s")
        clock.start()
        norm = None if lay is None else lay.global_norm(grads)
        adapters, opt_state, ostats = adamw_update(grads, opt_state, adapters,
                                                   scfg.optim,
                                                   grad_norm=norm)
        clock.stop("optim_s")
        return adapters, opt_state, {"loss": loss, **ostats}

    train_step.layout = lay
    return train_step


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------


def make_precompute_step(mcfg: ModelConfig, scfg: StepConfig, mesh=None,
                         *, fold_gsb: bool = False):
    """(params, adapters) -> serving adapter tree: every adapter leaf gains
    a cached "g" (and "gsB" when folded), so prefill and decode do no norm
    work. The eps is the model dtype's, as the uncached forward uses.

    ``mesh``: params and adapters are this rank's shards, and so is the
    state: g laid out like m, the folded gsB like B (row-sharded for the
    column-parallel modules, whole on every rank for wo and w_down), as
    ``launch/sharding.py adapter_sharding(serving=True)`` specifies and
    as each leaf's shape is checked against. The row-parallel modules sum
    their norm's partials over ``model`` (``precompute_adapter_state``'s
    ``sp``)."""
    from repro_torch.launch import sharding as S

    sp = None
    if mesh is not None:
        _mesh_rules(mcfg, scfg, mesh)
        sp = S.make_boundary_constraint(mesh, batch=1, seq=1, decode=True)

    def precompute_step(params, adapters):
        tree = precompute_adapter_state(params, adapters, scfg.dora,
                                        act_dtype=mcfg.dtype,
                                        fold_gsb=fold_gsb, sp=sp)
        if mesh is not None:
            check_serving_layout(mcfg, scfg, mesh, tree)
        return tree

    return precompute_step


def check_serving_layout(mcfg: ModelConfig, scfg: StepConfig, mesh, tree,
                         *, tenants: int | None = None) -> None:
    """Refuse a serving tree whose leaves are not this rank's shards on
    ``mesh``: g laid out like m and gsB like B, as ``launch/sharding.py
    adapter_sharding(serving=True)`` specifies. ``tenants``: the tree is
    a stack of that many states on axis 1 ([n_scan, K, ...]), laid out
    by ``fleet_stack_sharding`` (the tenant axis whole)."""
    from repro_torch.launch import sharding as S

    spec = S.adapter_sharding(mcfg, scfg.dora, mesh, serving=True)
    if tenants is not None:
        spec = S.fleet_stack_sharding(spec, mesh)
    serving = flatten_paths(spec)
    shapes = flatten_paths(adapter_shapes(mcfg, scfg.dora))
    for name, leaf in flatten_paths(tree).items():
        like = {"g": "m", "gsB": "B"}.get(name.rsplit("/", 1)[1])
        full = tuple(shapes[name if like is None
                            else f"{name.rsplit('/', 1)[0]}/{like}"].shape)
        if tenants is not None:
            full = full[:1] + (tenants,) + full[1:]
        want = _sh.local_shape(full, serving[name], mesh)
        if tuple(leaf.shape) != want:
            raise ValueError(
                f"serving leaf {name} {tuple(leaf.shape)} is not {full} "
                f"laid out {tuple(serving[name])} on mesh "
                f"{dict(mesh.shape)}: want {want}")


def make_prefill_step(mcfg: ModelConfig, scfg: StepConfig, mesh=None, *,
                      batch: int, seq: int, padded: bool = False,
                      tenant_groups=None):
    """(params, adapters, batch_in) -> (last_logits [B, V], cache).

    Runs the prompt and fills a fresh cache of ``seq`` positions on the
    prompt's device. Unpadded: the prompt is ``batch_in["tokens"]``
    [batch, P] (or a frontend's ``batch_in["embeds"]`` [batch, P,
    d_model]) with P ≤ ``seq`` and the cache ends at P.
    ``padded=True``: the prompt arrives right-padded to ``seq`` with the
    true length P in ``batch_in["prompt_len"]``; the logits are gathered
    at P-1 and the cache length is rewound to P, so the first decode token
    overwrites the first padded row (the padded rows beyond it are masked
    by causality). Only attention caches can rewind: a Mamba state has
    integrated the padded tokens, so a stack with Mamba layers refuses
    ``padded=True``.

    ``tenant_groups``: multi-tenant serving, static ``(start, size)`` row
    blocks grouping the batch by adapter; the adapter tree must be the
    stacked folded serving state (see ``repro_torch.launch.serve``).

    ``mesh``: the forward on this rank's shards and batch rows
    [batch / data, P], sequence-parallel over ``model``, padded or not.
    The adapters are the raw tree (each module's norm computed here, its
    partials summed over ``model`` for wo and w_down) or the serving state
    of ``make_precompute_step(mcfg, scfg, mesh)``; with ``tenant_groups``
    (the whole batch's) a stack of such states, and the groups are cut
    to this replica's rows once, here (``launch/sharding.py
    local_tenant_groups``). The logits are
    gathered over the vocab ([batch / data, V]). The cache holds the K/V
    of this rank's ``Hkv / tp`` heads for its data replica's rows: the
    runtime lays K/V out by heads, so attention needs no collective, and
    ``launch/sharding.py cache_sharding``'s T over ``model`` is a storage
    rule it does not take (every mesh ``mesh_layout`` accepts splits the
    KV heads). ``prefill_step.layout`` is the :class:`MeshLayout`, None
    without a mesh."""
    lay = None if mesh is None else mesh_layout(mcfg, scfg, mesh,
                                                batch=batch, seq=seq)
    rows = batch if lay is None else lay.local_batch
    tenant_groups = _local_groups(mesh, batch, tenant_groups)
    if padded and any(k != "attn" for k in mcfg.layer_kinds()):
        raise ValueError(
            "padded prefill requires attention-only caches: SSM layer "
            "states integrate the padded tokens and cannot be rewound "
            f"(arch {mcfg.name!r} has {mcfg.layer_kinds()})")

    @torch.no_grad()
    def prefill_step(params, adapters, batch_in):
        inputs = _inputs(batch_in)
        (name, x), = inputs.items()
        shape = tuple(x.shape)
        p_max = shape[1] if len(shape) == (2 if name == "tokens" else 3) \
            else -1
        fits = p_max == seq if padded else 0 < p_max <= seq
        if shape[:1] != (rows,) or not fits:
            want = seq if padded else f"P <= {seq}"
            raise ValueError(f"prefill built for {name} [{rows}, {want}], "
                             f"got {shape}")
        cache = init_cache(mcfg, batch, seq, mesh=mesh, device=x.device)
        kw = {}
        if padded:
            p_len = int(batch_in["prompt_len"])
            kw["gather_position"] = p_len - 1
        else:
            kw["loss_slice"] = 1
        logits, new_cache = forward(
            mcfg, params, adapters, scfg.dora, **inputs, cache=cache,
            training=False, tenant_groups=tenant_groups,
            boundary_constraint=None if lay is None else lay.sp, **kw)
        if padded:
            new_cache["len"] = p_len
        return _gather_vocab(logits[:, -1], mcfg, lay,
                             "prefill.logits"), new_cache

    prefill_step.layout = lay
    return prefill_step


def make_prefill_into_slot_step(mcfg: ModelConfig, scfg: StepConfig,
                                mesh=None, *, seq: int):
    """(params, adapters, cache, batch_in) -> (logits [1, V], cache).

    Continuous-batching admission (``launch/engine.py``): prefill ONE new
    request into row ``batch_in["slot"]`` of a running batch's rectangular
    row-length cache (``init_cache(..., row_lens=True)``) and leave every
    other row as it is. ``batch_in``: the prompt right-padded to ``seq``
    as "tokens" [1, seq] and its true length "prompt_len". The row runs
    the padded batch-1 prefill of :func:`make_prefill_step`, its K/V
    [seq] are copied into the slot's row in place and ``len[slot]``
    becomes P, so the first decoded token writes at position P. The
    engine also re-admits a preempted request through this step, with
    prompt + the tokens generated so far.

    ``mesh``: the cache is this rank's (``init_cache(mesh=)``). Every data
    replica prefills the row (a batch of one takes no data axis), in the
    sequence-parallel layout over ``model``, so ``seq`` must split over
    it; the replica that holds slot ``slot`` (``launch/sharding.py
    local_rows``) copies the row's K/V of this rank's heads into its
    cache, the others drop them. ``len`` is whole on every rank and the
    logits are gathered over the vocab, the same on every rank."""
    from repro_torch.launch.sharding import local_rows

    row_prefill = make_prefill_step(mcfg, scfg, mesh, batch=1, seq=seq,
                                    padded=True)

    @torch.no_grad()
    def prefill_into_slot(params, adapters, cache, batch_in):
        if "pages" in cache:
            raise ValueError("prefill_into_slot fills a rectangular cache; "
                             "a paged cache is admitted in chunks "
                             "(make_prefill_chunk_step)")
        p_len, slot = int(batch_in["prompt_len"]), int(batch_in["slot"])
        logits, row = row_prefill(params, adapters,
                                  {"tokens": batch_in["tokens"],
                                   "prompt_len": p_len})
        n = cache["len"].shape[0]
        mine = slice(0, n) if mesh is None else local_rows(mesh, n)
        if mine.start <= slot < mine.stop:
            for li, layer in cache["stack"].items():
                for name, big in layer.items():
                    big[:, slot - mine.start] = row["stack"][li][name][:, 0]
        cache["len"][slot] = p_len
        return logits, cache

    return prefill_into_slot


def make_prefill_chunk_step(mcfg: ModelConfig, scfg: StepConfig, mesh=None,
                            *, chunk: int):
    """(params, adapters, cache, batch_in) -> (logits [1, V], cache).

    Chunked admission into the PAGED cache (``launch/engine.py``): run
    ``chunk`` prompt tokens of one request into its slot's blocks of a
    running batch's shared pools, so a long prompt streams in between
    decode ticks. ``batch_in``: "tokens" [1, chunk] (the chunk's tokens,
    right-padded) and the ints "slot", "start" and "chunk_len".

    ``start`` is the HOST's admission frontier, not the device
    ``len[slot]``: every decode tick advances all rows' lengths, a row
    still admitting included, so the device value drifts. The forward runs
    over a batch-1 view (the shared pools, the slot's row of the table,
    ``len = [start]``), the K/V land in the pools in place, ``len[slot]``
    becomes ``start + chunk_len``, and the logits are taken at
    ``chunk_len - 1``: on the final chunk, the first token's.

    ``mesh``: the cache is this rank's (``init_cache(mesh=)``): every data
    replica runs the chunk (a batch of one takes no data axis) in the
    sequence-parallel layout over ``model``, so ``chunk`` must split over
    it, and writes its K/V heads into its own copy of the pools; the
    logits are gathered over the vocab, the same on every rank."""
    lay = None if mesh is None else mesh_layout(mcfg, scfg, mesh, batch=1,
                                                seq=chunk)

    @torch.no_grad()
    def prefill_chunk(params, adapters, cache, batch_in):
        tokens = batch_in["tokens"]
        if tuple(tokens.shape) != (1, chunk):
            raise ValueError(f"chunk step built for tokens [1, {chunk}], "
                             f"got {tuple(tokens.shape)}")
        slot, start = int(batch_in["slot"]), int(batch_in["start"])
        c_len = int(batch_in["chunk_len"])
        lens = cache["len"]
        view = {"stack": cache["stack"],
                "len": torch.full((1,), start, dtype=lens.dtype,
                                  device=lens.device),
                "pages": cache["pages"][slot:slot + 1]}
        logits, _ = forward(mcfg, params, adapters, scfg.dora,
                            tokens=tokens, cache=view, training=False,
                            gather_position=c_len - 1,
                            boundary_constraint=None if lay is None
                            else lay.sp)
        lens[slot] = start + c_len
        last = _gather_vocab(logits[:, -1], mcfg, lay, "chunk.logits")
        return last, cache

    return prefill_chunk


def _local_groups(mesh, batch: int, tenant_groups):
    """A step's static tenant groups as its forward takes them: under a
    mesh this data replica's (``launch/sharding.py
    local_tenant_groups``), else as given."""
    if mesh is None or tenant_groups is None:
        return tenant_groups
    from repro_torch.launch.sharding import local_tenant_groups
    return local_tenant_groups(mesh, batch, tenant_groups)


def _gather_vocab(last, mcfg: ModelConfig, lay, tag: str):
    """A step's last logits [B, V/tp] under ``lay`` gathered over the
    vocab ([B, V]); as they are without a mesh or with the head
    replicated."""
    if lay is None or last.shape[-1] == mcfg.vocab_size:
        return last
    return _sh.all_gather(last.contiguous(), (lay.sp.axis,), lay.mesh,
                          last.ndim - 1, tag=tag)


def _serve_rows(mcfg: ModelConfig, scfg: StepConfig, lay, *, batch: int,
                width: int, step: str, tags: tuple[str, str], params,
                adapters, cache, batch_in, inputs, tenant_groups=None,
                dynamic_groups: bool = False, last: bool = True):
    """The decode, draft and verify steps' forward over ``width`` new
    positions a row: logits [rows, V] of the last position (``last``) or
    [rows, width, V], and the cache.

    Under a mesh the engine's cache (per-row "len" [batch], whole on
    every rank) takes the whole batch's ``inputs`` [batch, width]: the
    forward runs this data replica's rows of them, of "len" and of a
    paged cache's "pages" (``launch/sharding.py local_rows``; each
    replica then writes only its rows' blocks of the pool) and of a
    dynamic index (``local_adapter_idx``), every row's "len" advances by
    ``width`` as on one card, and the logits are gathered over the vocab
    (tag ``tags[0]``) and then over the data axes (``tags[1]``), the
    whole batch's on every rank."""
    (name, x), = inputs.items()
    whole = lay is not None and isinstance(cache["len"], torch.Tensor) \
        and cache["len"].ndim == 1
    rows = batch if lay is None or whole else lay.local_batch
    if tuple(x.shape[:2]) != (rows, width):
        raise ValueError(f"{step} built for {name} [{rows}, {width}], got "
                         f"{tuple(x.shape)}")
    tg = (torch.as_tensor(batch_in["adapter_idx"], device=x.device)
          if dynamic_groups else tenant_groups)
    view = cache
    if whole:
        from repro_torch.launch.sharding import local_adapter_idx, local_rows
        mine = local_rows(lay.mesh, batch)
        inputs = {name: x[mine]}
        view = {**cache, "len": cache["len"][mine]}
        if "pages" in cache:
            view["pages"] = cache["pages"][mine]
        if dynamic_groups:
            tg = local_adapter_idx(lay.mesh, tg)
    logits, new_cache = forward(
        mcfg, params, adapters, scfg.dora, **inputs, cache=view,
        training=False, tenant_groups=tg,
        boundary_constraint=None if lay is None else lay.sp)
    out = _gather_vocab(logits[:, -1] if last else logits, mcfg, lay,
                        tags[0])
    if whole:
        new_cache = {**new_cache, "len": cache["len"] + width}
        if "pages" in cache:
            new_cache["pages"] = cache["pages"]
        if lay.dp_size > 1:
            out = _sh.all_gather(out.contiguous(), lay.dp_axes, lay.mesh, 0,
                                 tag=tags[1])
    return out, new_cache


def _check_grouping(tenant_groups, dynamic_groups: bool) -> None:
    if dynamic_groups and tenant_groups is not None:
        raise ValueError(
            "dynamic_groups=True takes the per-row adapter index from "
            "batch_in['adapter_idx']; a static tenant_groups signature "
            "cannot be given at the same time")


def make_decode_step(mcfg: ModelConfig, scfg: StepConfig, mesh=None, *,
                     batch: int, tenant_groups=None,
                     dynamic_groups: bool = False):
    """(params, adapters, cache, batch_in) -> (logits [B, V], cache'): one
    new token ``batch_in["tokens"]`` [B, 1] (or a frontend's
    ``batch_in["embeds"]`` [B, 1, d_model]) against the cache, written in
    place at position ``cache["len"]``: one int for the whole batch, or a
    [B] tensor of per-row lengths (continuous batching), where each row
    writes and attends at its own position.

    ``tenant_groups``: multi-tenant serving, the rows grouped by adapter
    in static ``(start, size)`` blocks over the stacked folded serving
    state; the step does no norm work (no K1 launch).
    ``dynamic_groups``: each row's adapter is the int [B] stack position
    ``batch_in["adapter_idx"]``, so the tenant mix changes values, not the
    step. Mutually exclusive with a static ``tenant_groups``.

    ``mesh``: this rank's shards, its data replica's rows [batch / data,
    1] and the cache its prefill filled (this rank's K/V heads). Decode's
    S = 1 cannot be split, so the step runs the tensor-parallel layout
    with the sequence whole (``mesh_layout(decode=True)``): the masked
    vocab-parallel lookup summed over ``model``, the column-parallel
    projections on their local rows, attention on the local heads with no
    collective, the row-parallel ones all-reducing y_base and the r-wide
    h over ``model`` (fp32) before the compose, and the head's local
    vocab columns gathered ([batch / data, V], tag "decode.logits"). The
    adapters must be the serving state of ``make_precompute_step(mcfg,
    scfg, mesh)``, or with ``tenant_groups`` (the whole batch's) or
    ``dynamic_groups`` a stack of such states ([n_scan, K, ...],
    ``launch/sharding.py fleet_stack_sharding``); static groups are cut
    to this replica's rows once, here (``local_tenant_groups``), and a
    grouped or dynamic step moves the single-tenant step's collective
    bytes. The engine's cache (``init_cache(row_lens=True, mesh=)``:
    "len" [batch] and a paged cache's "pages" [batch, max_blocks] whole
    on every rank) takes the whole batch's tokens [batch, 1] and
    ``adapter_idx`` [batch] instead (:func:`_serve_rows`; the data
    gather's tag "engine.logits"). ``decode_step.layout`` is the
    :class:`MeshLayout`, None without a mesh."""
    _check_grouping(tenant_groups, dynamic_groups)
    lay = None if mesh is None else mesh_layout(mcfg, scfg, mesh,
                                                batch=batch, seq=1,
                                                decode=True)
    tenant_groups = _local_groups(mesh, batch, tenant_groups)

    @torch.no_grad()
    def decode_step(params, adapters, cache, batch_in):
        return _serve_rows(mcfg, scfg, lay, batch=batch, width=1,
                           step="decode",
                           tags=("decode.logits", "engine.logits"),
                           params=params, adapters=adapters, cache=cache,
                           batch_in=batch_in, inputs=_inputs(batch_in),
                           tenant_groups=tenant_groups,
                           dynamic_groups=dynamic_groups)

    decode_step.layout = lay
    return decode_step


def make_draft_step(mcfg: ModelConfig, scfg: StepConfig, mesh=None, *,
                    batch: int):
    """(params, cache, batch_in) -> (logits [B, V], cache').

    The speculative draft: one token ``batch_in["tokens"]`` [B, 1] through
    the BASE model only. The adapter tree is the empty dict, so every
    projection takes ``maybe_dora``'s base matmul: no ``dora_linear``, no
    norm and no gsB work. ``scfg.dora`` still reaches the attention, so a
    paged cache gathers through K8 as in decode. The cache contract is the
    decode step's: per-row "len", each row writing and attending at its own
    position. The verify rewrites every drafted position with full-path
    K/V, so no base-path K/V survives into the committed cache (see
    ``launch/engine.py``).

    ``mesh``: as :func:`make_decode_step`, in the decode layout: the
    engine's whole per-row cache and the whole batch's tokens, this
    replica's rows run, every row's "len" advanced by 1, the logits
    gathered over the vocab ("draft.logits") and the data axes
    ("engine.draft.logits"). With no adapter the row-parallel projections
    all-reduce y_base alone: the decode step's bytes less ``tp.h``.
    ``draft_step.layout`` is the :class:`MeshLayout`, None without a
    mesh."""
    lay = None if mesh is None else mesh_layout(mcfg, scfg, mesh,
                                                batch=batch, seq=1,
                                                decode=True)

    @torch.no_grad()
    def draft_step(params, cache, batch_in):
        return _serve_rows(mcfg, scfg, lay, batch=batch, width=1,
                           step="draft",
                           tags=("draft.logits", "engine.draft.logits"),
                           params=params, adapters={}, cache=cache,
                           batch_in=batch_in,
                           inputs={"tokens": batch_in["tokens"]})

    draft_step.layout = lay
    return draft_step


def make_verify_step(mcfg: ModelConfig, scfg: StepConfig, mesh=None, *,
                     batch: int, window: int, tenant_groups=None,
                     dynamic_groups: bool = False):
    """(params, adapters, cache, batch_in) -> (logits [B, window, V],
    cache').

    The speculative verify: score ``window`` = k + 1 positions
    ``batch_in["tokens"]`` [B, window] per row in ONE forward through the
    full adapted path, the one the decode step runs, each row at its own
    frontier (per-row "len" and causal mask, the dense attention path).
    Logits come back for EVERY window position: position j scores the
    draft at j + 1 and gives the correction where the draft diverges. The
    K/V of the whole window are written at each row's frontier, over the
    drafts' base-path K/V, and "len" advances by ``window``; the engine
    rewinds it to each row's accepted frontier.

    ``tenant_groups`` and ``dynamic_groups``: as for
    :func:`make_decode_step`, the rows grouped by adapter in static
    ``(start, size)`` blocks, or each row's adapter the int [B] stack
    position ``batch_in["adapter_idx"]``; mutually exclusive.

    ``mesh``: as :func:`make_decode_step`, in the decode layout with the
    window whole on every rank (``make_boundary_constraint(decode=True)``
    takes any S: each row's frontier and its K/V writes need the whole
    window); static groups cut to this replica's rows, the engine's whole
    cache, tokens and index taken as the decode step takes them, every
    row's "len" advanced by ``window``, and the logits of every window
    position gathered over the vocab ("verify.logits") and the data axes
    ("engine.verify.logits"): [batch, window, V] on every rank, so the
    host's accept and rewind decisions are the same on each.
    ``verify_step.layout`` is the :class:`MeshLayout`, None without a
    mesh."""
    _check_grouping(tenant_groups, dynamic_groups)
    lay = None if mesh is None else mesh_layout(mcfg, scfg, mesh,
                                                batch=batch, seq=window,
                                                decode=True)
    tenant_groups = _local_groups(mesh, batch, tenant_groups)

    @torch.no_grad()
    def verify_step(params, adapters, cache, batch_in):
        return _serve_rows(mcfg, scfg, lay, batch=batch, width=window,
                           step="verify",
                           tags=("verify.logits", "engine.verify.logits"),
                           params=params, adapters=adapters, cache=cache,
                           batch_in=batch_in,
                           inputs={"tokens": batch_in["tokens"]},
                           tenant_groups=tenant_groups,
                           dynamic_groups=dynamic_groups, last=False)

    verify_step.layout = lay
    return verify_step
