"""Step functions (counterpart of ``repro/launch/steps.py``): the train
step, and the serving steps precompute, padded prefill, decode, and the
continuous-batching engine's prefill-into-slot, prefill-chunk, and the
speculative draft and verify.

Each builder returns a plain function over (params, adapters, ...). The
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

from repro_torch.core.adapter import precompute_adapter_state
from repro_torch.core.config import DoRAConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import forward, init_cache
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


def _inputs(batch_in) -> dict:
    """The forward's input from a batch: {"embeds": ...} when the batch
    carries a frontend's precomputed embeddings, else {"tokens": ...}."""
    if "embeds" in batch_in:
        return {"embeds": batch_in["embeds"]}
    return {"tokens": batch_in["tokens"]}


def make_grad_step(mcfg: ModelConfig, scfg: StepConfig, *, batch: int,
                   seq: int):
    """(params, adapters, batch_in) -> (loss, grads): the train step
    without its optimizer update.

    ``batch_in``: {"tokens", "labels"} int [batch, seq], or {"embeds",
    "labels"} with a frontend's embeddings [batch, seq, d_model] in place
    of the tokens. ``grads`` has the
    adapter tree's structure; the frozen base params get no gradient.
    ``scfg.loss_tokens``: the loss reads only the last N positions (the
    head runs on those alone). ``scfg.grad_accum`` = ga: the batch is
    split into ga microbatches along its first dim, their gradients
    summed in fp32 and divided by ga, as the reference's scan does."""
    lt = scfg.loss_tokens
    ga = max(scfg.grad_accum, 1)
    if batch % ga:
        raise ValueError(f"batch {batch} is not divisible by grad_accum "
                         f"{ga}")

    def loss_fn(params, adapters, inputs, labels):
        logits, _ = forward(mcfg, params, adapters, scfg.dora, **inputs,
                            training=True, loss_slice=lt)
        lbl = labels if lt is None or lt >= labels.shape[1] \
            else labels[:, -lt:]
        return cross_entropy(logits, lbl)

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

    def grad_step(params, adapters, batch_in):
        inputs, labels = _inputs(batch_in), batch_in["labels"]
        (name, x), = inputs.items()
        if tuple(x.shape[:2]) != (batch, seq) \
                or tuple(labels.shape) != (batch, seq):
            raise ValueError(f"step built for [{batch}, {seq}] {name} and "
                             f"labels, got {tuple(x.shape)} and "
                             f"{tuple(labels.shape)}")
        if ga == 1:
            return value_and_grad(params, adapters, inputs, labels)
        mb = batch // ga
        loss = torch.zeros((), dtype=_F32, device=x.device)
        grads = tree_map(lambda a: torch.zeros(a.shape, dtype=_F32,
                                               device=a.device), adapters)
        for i in range(ga):
            rows = slice(i * mb, (i + 1) * mb)
            loss_i, g_i = value_and_grad(params, adapters,
                                         {name: x[rows]}, labels[rows])
            loss = loss + loss_i
            tree_map(lambda acc, g: acc.add_(g), grads, g_i)
        return loss / ga, tree_map(lambda g: g / ga, grads)

    return grad_step


def make_train_step(mcfg: ModelConfig, scfg: StepConfig, *, batch: int,
                    seq: int):
    """(params, adapters, opt_state, batch_in, stats=None) -> (adapters',
    opt_state', metrics): :func:`make_grad_step`, then AdamW.

    The adapters and the AdamW state are updated in place (the returned
    trees are the ones given). ``metrics``: {"loss", "grad_norm"} fp32 0-d
    tensors and the float "lr". ``stats``: when given, filled with the
    wall seconds of the forward+backward (``grad_s``) and of the optimizer
    (``optim_s``), each ended by a device synchronisation."""
    grad_step = make_grad_step(mcfg, scfg, batch=batch, seq=seq)

    def train_step(params, adapters, opt_state, batch_in, stats=None):
        clock = PhaseClock(stats, batch_in["labels"].device)
        clock.start()
        loss, grads = grad_step(params, adapters, batch_in)
        clock.stop("grad_s")
        clock.start()
        adapters, opt_state, ostats = adamw_update(grads, opt_state, adapters,
                                                   scfg.optim)
        clock.stop("optim_s")
        return adapters, opt_state, {"loss": loss, **ostats}

    return train_step


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------


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
                      seq: int, padded: bool = False, tenant_groups=None):
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
    stacked folded serving state (see ``repro_torch.launch.serve``)."""
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
        if shape[:1] != (batch,) or not fits:
            want = seq if padded else f"P <= {seq}"
            raise ValueError(f"prefill built for {name} [{batch}, {want}], "
                             f"got {shape}")
        cache = init_cache(mcfg, batch, seq, device=x.device)
        kw = {}
        if padded:
            p_len = int(batch_in["prompt_len"])
            kw["gather_position"] = p_len - 1
        else:
            kw["loss_slice"] = 1
        logits, new_cache = forward(mcfg, params, adapters, scfg.dora,
                                    **inputs, cache=cache, training=False,
                                    tenant_groups=tenant_groups, **kw)
        if padded:
            new_cache["len"] = p_len
        return logits[:, -1], new_cache

    return prefill_step


def make_prefill_into_slot_step(mcfg: ModelConfig, scfg: StepConfig, *,
                                seq: int):
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
    prompt + the tokens generated so far."""
    row_prefill = make_prefill_step(mcfg, scfg, batch=1, seq=seq,
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
        for li, layer in cache["stack"].items():
            for name, big in layer.items():
                big[:, slot] = row["stack"][li][name][:, 0]
        cache["len"][slot] = p_len
        return logits, cache

    return prefill_into_slot


def make_prefill_chunk_step(mcfg: ModelConfig, scfg: StepConfig, *,
                            chunk: int):
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
    ``chunk_len - 1``: on the final chunk, the first token's."""

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
                            gather_position=c_len - 1)
        lens[slot] = start + c_len
        return logits[:, -1], cache

    return prefill_chunk


def make_decode_step(mcfg: ModelConfig, scfg: StepConfig, *, batch: int,
                     tenant_groups=None, dynamic_groups: bool = False):
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
    step. Mutually exclusive with a static ``tenant_groups``."""
    if dynamic_groups and tenant_groups is not None:
        raise ValueError(
            "dynamic_groups=True takes the per-row adapter index from "
            "batch_in['adapter_idx']; a static tenant_groups signature "
            "cannot be given at the same time")

    @torch.no_grad()
    def decode_step(params, adapters, cache, batch_in):
        inputs = _inputs(batch_in)
        (name, x), = inputs.items()
        if tuple(x.shape[:2]) != (batch, 1):
            raise ValueError(f"decode built for {name} [{batch}, 1], got "
                             f"{tuple(x.shape)}")
        tg = (torch.as_tensor(batch_in["adapter_idx"], device=x.device)
              if dynamic_groups else tenant_groups)
        logits, new_cache = forward(mcfg, params, adapters, scfg.dora,
                                    **inputs, cache=cache, training=False,
                                    tenant_groups=tg)
        return logits[:, -1], new_cache

    return decode_step


def make_draft_step(mcfg: ModelConfig, scfg: StepConfig, *, batch: int):
    """(params, cache, batch_in) -> (logits [B, V], cache').

    The speculative draft: one token ``batch_in["tokens"]`` [B, 1] through
    the BASE model only. The adapter tree is the empty dict, so every
    projection takes ``maybe_dora``'s base matmul: no ``dora_linear``, no
    norm and no gsB work. ``scfg.dora`` still reaches the attention, so a
    paged cache gathers through K8 as in decode. The cache contract is the
    decode step's: per-row "len", each row writing and attending at its own
    position. The verify rewrites every drafted position with full-path
    K/V, so no base-path K/V survives into the committed cache (see
    ``launch/engine.py``)."""

    @torch.no_grad()
    def draft_step(params, cache, batch_in):
        tokens = batch_in["tokens"]
        if tuple(tokens.shape) != (batch, 1):
            raise ValueError(f"draft built for tokens [{batch}, 1], got "
                             f"{tuple(tokens.shape)}")
        logits, new_cache = forward(mcfg, params, {}, scfg.dora,
                                    tokens=tokens, cache=cache,
                                    training=False)
        return logits[:, -1], new_cache

    return draft_step


def make_verify_step(mcfg: ModelConfig, scfg: StepConfig, *, batch: int,
                     window: int, tenant_groups=None,
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
    position ``batch_in["adapter_idx"]``; mutually exclusive."""
    if dynamic_groups and tenant_groups is not None:
        raise ValueError(
            "dynamic_groups=True takes the per-row adapter index from "
            "batch_in['adapter_idx']; a static tenant_groups signature "
            "cannot be given at the same time")

    @torch.no_grad()
    def verify_step(params, adapters, cache, batch_in):
        tokens = batch_in["tokens"]
        if tuple(tokens.shape) != (batch, window):
            raise ValueError(f"verify built for tokens [{batch}, {window}], "
                             f"got {tuple(tokens.shape)}")
        tg = (torch.as_tensor(batch_in["adapter_idx"], device=tokens.device)
              if dynamic_groups else tenant_groups)
        return forward(mcfg, params, adapters, scfg.dora, tokens=tokens,
                       cache=cache, training=False, tenant_groups=tg)

    return verify_step
