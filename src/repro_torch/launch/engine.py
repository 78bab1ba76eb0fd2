"""Continuous-batching decode engine (counterpart of
``repro/launch/engine.py``).

The static serve loop (``launch/serve.py``) retires a batch only when
every row is done. This engine keeps the decode batch full instead:

  - **slot table**: the decode batch is ``slots`` fixed rows over ONE
    persistent cache whose "len" is a per-row tensor
    (``init_cache(..., row_lens=True)``), so every row stands at its own
    position, attends under its own causal frontier and writes its K/V
    at its own depth;
  - **admission**: a queued request is prefilled INTO a free row of the
    running batch (``make_prefill_into_slot_step``) while the other rows
    are left as they are;
  - **retirement**: a row retires the moment its request finishes (EOS,
    its token budget, or the cache's ``max_len``), and the freed slot
    admits the next queued request at the next engine step;
  - **per-slot adapters** (``adapter_cache``): requests carry adapter
    handles resolved through an
    :class:`~repro_torch.core.adapter_cache.AdapterStateCache` at submit
    time. Slots whose handles coincide take the single-tenant path
    (signature ``None``); mixed slot tables group contiguous same-handle
    runs through the grouped gsB compose
    (``core/adapter.py::dora_linear_grouped``), free slots absorbed into
    a neighbouring run;
  - **dynamic grouping** (``dynamic_grouping=True``): the static
    ``(start, size)`` signature gives way to a FLEET STACK of serving
    states on the device indexed by a per-row position
    (``batch_in["adapter_idx"]``), so tenant churn changes values, never
    the step: every decode runs under the one signature ``"dynamic"``.

With ``paged=True`` the rectangular K/V gives way to a block pool per
layer and a per-slot block table (``cache["pages"]``): blocks are
allocated as a row's frontier crosses into them and freed at retirement
or preemption, and prompts are admitted in fixed-size chunks interleaved
with decode ticks (``make_prefill_chunk_step``). The attention gathers
the pools through the table with K8 (``kernels/paged_gather.py``).
Greedy paged streams equal the rectangular engine's.

Scheduling is HOST logic over host mirrors (per-slot positions, budgets
and block lists): the engine never reads ``cache["len"]`` or the table
back from the device, and writes the table to the device once before
each device step that reads it (:meth:`DecodeEngine._flush_pages`). The
only read-back per step is the logits fetch that sampling needs. The
schedule is deterministic and model-independent when no ``eos_id`` is
set, so its counters equal the models committed in ``BENCH_serve.json``.

Sampling: greedy is a host argmax over the fetched logits. With
``temperature > 0`` each request draws from its own ``torch.Generator``,
seeded from (seed, key_id, number of tokens sampled so far), so a
request's stream does not depend on what shares its batch; these draws
are not the reference's ``jax.random`` draws.

Speculative decoding (``speculative_k``): a tick drafts k tokens a row
through the base model alone (``make_draft_step``), verifies the k + 1
window in one forward through the adapted path (``make_verify_step``,
grouped like decode), accepts each row's longest matching prefix plus
the verify's own token, and rewinds ``cache["len"]`` to each row's
accepted frontier; an accept-rate ladder turns it off and on again. The
fault plan (``fault_plan``, ``launch/faults.py``) poisons fetched logits
rows, stalls ticks, invalidates the adapter cache and hands an admission
a stale handle. Tracing (``trace``, ``repro_torch/obs``) records the
reference's lifecycle, fault and cache events from host scalars.

The reference's ``compile_counts()`` counts XLA executables, which
PyTorch does not have: :meth:`DecodeEngine.device_steps` counts the
device steps the engine ran, and :meth:`DecodeEngine.step_signatures`
the decode and verify steps run under each group signature. A device
mesh (``mesh``) is refused: multi-device serving is ROADMAP queue 1
item 6.

SSM/Mamba archs are refused (their states integrate every processed
token and cannot rewind to a slot's true prompt length), and MoE FFNs
too (expert-capacity dispatch couples rows).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.core.adapter import stack_adapter_states
from repro_torch.core.adapter_cache import (AdapterHandle, AdapterStateCache,
                                            mesh_fingerprint)
from repro_torch.launch.faults import FaultPlan
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.steps import (StepConfig, make_decode_step,
                                      make_draft_step,
                                      make_prefill_chunk_step,
                                      make_prefill_into_slot_step,
                                      make_verify_step)
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import init_cache
from repro_torch.tree import tree_map

#: Every finish_reason a RequestResult can carry.
#:   eos           the request's eos_id was sampled
#:   length        the request's max_new_tokens budget ran out
#:   max_len       the CACHE bound ran out before the request's budget
#:   error         admission-time resolution failed (error_type/_message)
#:   timeout       deadline_ticks expired (queued or mid-decode); tokens
#:                 generated so far are delivered
#:   error_numeric the row's logits went non-finite and it was quarantined
FINISH_REASONS = ("eos", "length", "max_len", "error", "timeout",
                  "error_numeric")

# The leaves of a folded serving state that the grouped compose reads
# (``dora_linear_grouped``: A for h = x·Aᵀ, g and gsB for the delta). The
# stacked trees of the static and dynamic groupings hold these alone: B
# and m are folded into gsB and g, and stacking them would add their
# bytes per stack position without changing an output.
_GROUPED_LEAVES = ("A", "g", "gsB")


def _grouped_view(state):
    """``state`` with every adapter leaf cut to :data:`_GROUPED_LEAVES`
    (the same tensors, no copy)."""
    if isinstance(state, dict) and "gsB" in state:
        return {k: state[k] for k in _GROUPED_LEAVES}
    return {k: _grouped_view(v) for k, v in state.items()}


class EngineBusy(RuntimeError):
    """Submit-time backpressure: the adapter-state cache is thrashing
    (every recent lookup an evicting miss) and admitting this cold
    request would stall the serve path on yet another full precompute.
    ``retry_after`` is the suggested backoff in engine ticks (the cache's
    thrash window)."""

    def __init__(self, message: str, retry_after: int = 1):
        super().__init__(message)
        self.retry_after = retry_after


@dataclasses.dataclass(frozen=True)
class EngineRequest:
    """One queued or running request (built by
    :meth:`DecodeEngine.submit`)."""
    request_id: int
    prompt: np.ndarray                 # int32 [P]
    adapter: AdapterHandle | None      # None = the engine's fixed adapters
    max_new_tokens: int
    eos_id: int | None = None
    key_id: int = 0                    # sampling stream id (see submit)
    state: Any = dataclasses.field(default=None, repr=False)
    #                                    serving tree pinned at submit: a
    #                                    tenant update() while the request
    #                                    waits does not change it
    priority: int = 0                  # higher admits first, preempts lower
    deadline_step: int | None = None   # ABSOLUTE engine step; -> "timeout"
    # -- continuation bookkeeping (set by preemption, not by submit) --------
    prefix: np.ndarray | None = None   # tokens generated before preemption
    orig_prompt: np.ndarray | None = None   # prompt as originally submitted
    resume_cap: str | None = None      # finish_cap carried across preemption
    first_admitted: int | None = None  # step of the FIRST admission
    preempted: int = 0                 # times this request was preempted


@dataclasses.dataclass
class RequestResult:
    """Everything the engine produced for one request. Errors are carried
    as ``error_type`` (the exception class name) and ``error_message``
    strings, so a result pickles; the live exception stays behind the
    :attr:`error` accessor in the process that produced it."""
    request_id: int
    prompt: np.ndarray                 # int32 [P] (as submitted)
    tokens: np.ndarray                 # int32 [n] generated tokens
    finish_reason: str                 # one of FINISH_REASONS
    admitted_step: int                 # engine step of the first admission
    finished_step: int                 # engine step the last token landed
    error_type: str | None = None      # exception class name, iff "error"
    error_message: str | None = None   # str(exception), iff "error"
    preempted: int = 0                 # times the request was preempted

    @property
    def error(self) -> Exception | None:
        """The live exception behind an ``"error"`` result, or None (after
        a pickle round trip)."""
        return getattr(self, "_live_error", None)

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_live_error", None)
        return state


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """Deterministic scheduling counters (point-in-time snapshot), with
    the reference's fields."""
    slots: int
    steps: int                  # engine steps driven (incl. idle ones)
    decode_steps: int           # steps that ran the batched PLAIN decode
    prefills: int               # completed admissions (prefill or chunks)
    admitted: int
    retired: int
    generated_tokens: int       # sampled tokens (admission, decode, verify)
    slot_steps: int             # sum over plain decode steps of active slots
    draft_steps: int = 0        # base-only draft forwards (speculative)
    verify_steps: int = 0       # k + 1-window verifies (= speculative ticks)
    accepted_drafts: int = 0    # draft tokens the verify accepted
    stack_inserts: int = 0      # fleet-stack writes (dynamic grouping): one
    #                             per DISTINCT handle seated, none per token
    preemptions: int = 0        # slots displaced (priority or pool reclaim)
    timeouts: int = 0           # requests retired by deadline expiry
    quarantined: int = 0        # rows retired with non-finite logits
    busy_rejections: int = 0    # submits refused with EngineBusy (thrash)
    spec_disables: int = 0      # speculative ladder trips (accept collapse)
    spec_reenables: int = 0     # speculative re-enables after the cooldown
    injected_nans: int = 0      # fault plan: logits rows poisoned
    forced_evictions: int = 0   # fault plan: adapter-cache invalidations
    stale_injected: int = 0     # fault plan: admissions given stale handles
    slow_ticks: int = 0         # fault plan: straggler sleeps

    @property
    def mean_occupancy(self) -> float:
        """Active rows per decode step / slots."""
        if self.decode_steps == 0:
            return 0.0
        return self.slot_steps / (self.decode_steps * self.slots)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["mean_occupancy"] = self.mean_occupancy
        return d


@dataclasses.dataclass
class _Slot:
    idx: int = -1                      # this slot's row index (fixed)
    req: EngineRequest | None = None
    handle: AdapterHandle | None = None
    state: Any = None                  # pinned serving tree for this row
    last_token: int = 0
    budget: int = 0                    # tokens still to sample
    finish_cap: str = "length"         # reason when the budget runs out
    generated: list = dataclasses.field(default_factory=list)
    admitted_step: int = 0
    pos: int = 0                       # host mirror of cache["len"][slot]
    n_prior: int = 0                   # tokens emitted in earlier legs of a
    #                                    preempted request (keeps the
    #                                    sampling stream continuous)
    prefilling: bool = False           # paged chunked admission in flight
    chunk_next: int = 0                # next chunk's start into the prompt

    @property
    def occupied(self) -> bool:
        """The slot holds a request (decoding OR mid-admission)."""
        return self.req is not None

    @property
    def active(self) -> bool:
        """The slot decodes this tick (admission, if any, is complete)."""
        return self.req is not None and not self.prefilling


class DecodeEngine:
    """Slot-scheduled continuous-batching serving over one decode step.

    ``adapters`` is EITHER one precomputed serving tree every request
    shares (``make_precompute_step``), OR None with an ``adapter_cache``
    (:class:`~repro_torch.core.adapter_cache.AdapterStateCache`): then
    every request carries an adapter id or handle resolved through the
    LRU at SUBMIT time, and the resolved state is pinned on the request
    (then on its slot) for its lifetime, so a tenant ``update()`` never
    swaps weights under a submitted request. ``allow_miss=False`` refuses
    a request whose state would need a precompute. ``device``: None is
    the card, which must be present; ``"cpu"`` is the explicit CPU
    request; ``params`` and the states must live there.

    ``step()`` is one scheduler tick: apply the fault plan's events →
    expire deadlines → admit into free slots (preempting lower-priority
    rows when an outranking request is queued) → one prompt chunk per
    admitting slot (paged) → one batched decode, or draft/verify/rewind,
    over every active slot. ``run()`` drives until the queue and the slot
    table drain.

    Fleet grouping: a static engine decodes under one group signature per
    layout of occupied slots (``None`` for one distinct handle, else the
    run-length ``(start, size)`` groups) and restacks the states only
    when that layout changes. ``dynamic_grouping=True`` (cache-routed
    engines only) seats each distinct handle at a position of a stack of
    ``slots`` serving states, refcounted across the slots sharing it and
    recycled at the last release, and every decode runs under the one
    signature ``"dynamic"``, at K = ``slots`` times the adapter work.
    ``max_active_per_adapter`` caps how many slots one adapter id holds:
    excess requests wait in the queue, keeping their positions. The
    stacked trees hold the leaves the grouped compose reads
    (:data:`_GROUPED_LEAVES`), not B and m.

    ``speculative_k`` = k > 0: a tick drafts k tokens a row through the
    base model alone, verifies the k + 1 window in one forward through
    the adapted path, emits each row's longest matching prefix plus the
    verify's own token and rewinds each row's length to its frontier.
    Greedy speculative streams equal plain greedy streams (the verify's
    logits at an accepted position are plain decode's, up to the
    summation order of a product over more rows). A tick decodes plainly
    at ``temperature > 0``, when a row's window would pass ``max_len``,
    and (paged) while a slot is mid-admission or when the pool cannot
    back every window. The ladder: when the mean accept rate of the last
    ``spec_window`` speculative ticks falls below ``spec_accept_floor``,
    the next ``spec_reenable_after`` ticks decode plainly.

    ``fault_plan`` (``launch/faults.py``): a ``nan`` event poisons its
    slot's fetched logits (admission or decode or verify) so the row is
    quarantined with ``finish_reason="error_numeric"``; ``slow`` sleeps
    at the top of the tick (capped at ``MAX_SLOW_S``); ``evict``
    invalidates the adapter cache (pinned states are untouched); ``stale``
    hands the next adapter-carrying admission a handle one version ahead
    with its pinned state stripped, so the cache's real stale error
    retires it with ``finish_reason="error"``. On a single-tenant engine
    ``evict`` and ``stale`` change nothing, as in the reference. A
    thrashing cache refuses a cold current handle at submit with
    :class:`EngineBusy`.

    ``trace``: a :class:`repro_torch.obs.TraceRecorder`; the engine emits
    the reference's lifecycle, fault, ladder and cache events, each
    stamped with the engine tick, from host scalars only (a traced engine
    claims the cache's ``on_event`` hook for ``spill``/``reload``).

    Paged knobs: ``block_size`` (default: the largest divisor of
    ``max_len`` up to 16), ``n_blocks`` (default: enough for every slot
    to reach ``max_len``; pass fewer to realise the memory win) and
    ``prefill_chunk`` (default: ``block_size``). When the pool runs out,
    an admission waits at the head of the queue, and a decoding row that
    needs a block preempts :meth:`_block_victim` slots until it fits.
    """

    def __init__(self, mcfg: ModelConfig, scfg: StepConfig, params, *,
                 slots: int, max_len: int, adapters=None,
                 adapter_cache: AdapterStateCache | None = None,
                 mesh=None, allow_miss: bool = True,
                 dynamic_grouping: bool = False,
                 max_active_per_adapter: int | None = None,
                 temperature: float = 0.0, seed: int = 0,
                 speculative_k: int = 0,
                 fault_plan: FaultPlan | None = None,
                 spec_accept_floor: float = 0.0, spec_window: int = 4,
                 spec_reenable_after: int = 8, paged: bool = False,
                 block_size: int | None = None,
                 n_blocks: int | None = None,
                 prefill_chunk: int | None = None, trace=None,
                 device=None):
        if mcfg.ssm or mcfg.attn_period:
            raise NotImplementedError(
                f"continuous batching requires attention-only caches: SSM "
                f"states integrate every processed token and cannot rewind "
                f"to a slot's true prompt length, so admission "
                f"(prefill-into-slot) and per-row retirement are "
                f"ill-defined (arch {mcfg.name!r})")
        if mcfg.moe:
            raise NotImplementedError(
                f"continuous batching does not support MoE FFNs: expert-"
                f"capacity dispatch couples batch rows, so a retired "
                f"slot's garbage tokens could evict a live row's tokens "
                f"from an expert (arch {mcfg.name!r})")
        if mesh is not None:
            raise NotImplementedError(
                "DecodeEngine(mesh=...) is not ported yet: it comes with "
                "multi-device serving (ROADMAP queue 1 item 6)")
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        if (adapters is None) == (adapter_cache is None):
            # Exactly one source of adapter state: a handle-less ACTIVE
            # slot beside cache-routed ones would look free to
            # _slot_grouping and decode under a neighbour's adapters.
            raise ValueError(
                "DecodeEngine needs EITHER a fixed precomputed `adapters` "
                "tree (single-tenant) OR an `adapter_cache` to resolve "
                "per-request adapter handles against — not both, not "
                "neither")
        if adapter_cache is not None \
                and adapter_cache.sharding != mesh_fingerprint(mesh):
            raise ValueError(
                f"adapter cache is keyed for sharding "
                f"{adapter_cache.sharding} but the engine runs on mesh "
                f"{mesh_fingerprint(mesh)} — build the cache with "
                f"AdapterStateCache.for_serving(mcfg, scfg) for THIS "
                f"layout")
        if dynamic_grouping and adapter_cache is None:
            raise ValueError(
                "dynamic_grouping=True requires an adapter_cache: the fleet "
                "stack is indexed by per-request adapter handles, which "
                "only cache-routed engines carry")
        if max_active_per_adapter is not None and max_active_per_adapter < 1:
            raise ValueError(
                f"max_active_per_adapter={max_active_per_adapter} < 1 would "
                f"make every adapter-carrying request permanently "
                f"inadmissible")
        if speculative_k < 0:
            raise ValueError(f"speculative_k={speculative_k} < 0")
        if not 0.0 <= spec_accept_floor <= 1.0:
            raise ValueError(
                f"spec_accept_floor={spec_accept_floor} not in [0, 1]")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine was asked on {self.device}")
        self.mcfg = mcfg
        self.scfg = scfg
        self.params = params
        self.adapters = adapters
        self.adapter_cache = adapter_cache
        self.allow_miss = allow_miss
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.speculative_k = int(speculative_k)
        self.fault_plan = fault_plan
        self.spec_accept_floor = float(spec_accept_floor)
        self.spec_window = int(spec_window)
        self.spec_reenable_after = int(spec_reenable_after)
        # -- paged K/V knobs -----------------------------------------------
        self._paged = bool(paged)
        if not self._paged and (block_size is not None or n_blocks is not None
                                or prefill_chunk is not None):
            raise ValueError(
                "block_size / n_blocks / prefill_chunk require paged=True")
        if self._paged:
            if block_size is None:
                block_size = max(d for d in range(1, min(16, self.max_len) + 1)
                                 if self.max_len % d == 0)
            self._block_size = int(block_size)
            if self.max_len % self._block_size != 0:
                raise ValueError(
                    f"max_len={self.max_len} must be a multiple of "
                    f"block_size={self._block_size}")
            self._max_blocks = self.max_len // self._block_size
            if n_blocks is None:
                n_blocks = self.slots * self._max_blocks
            self._n_blocks = int(n_blocks)
            if self._n_blocks < self._max_blocks:
                raise ValueError(
                    f"n_blocks={self._n_blocks} < max_blocks="
                    f"{self._max_blocks}: one slot alone must be able to "
                    f"grow to max_len, or the engine could deadlock with "
                    f"an admitted request it can never finish")
            self._chunk = int(prefill_chunk if prefill_chunk is not None
                              else self._block_size)
            if not 1 <= self._chunk <= self.max_len:
                raise ValueError(
                    f"prefill_chunk={self._chunk} not in [1, "
                    f"max_len={self.max_len}] (the chunk step's row writes "
                    f"must fit the logical window)")

        self.cache = init_cache(
            mcfg, self.slots, self.max_len, row_lens=True,
            block_size=self._block_size if self._paged else None,
            n_blocks=self._n_blocks if self._paged else None,
            device=self.device)
        if self._paged:
            self._chunk_prefill = make_prefill_chunk_step(mcfg, scfg,
                                                          chunk=self._chunk)
        else:
            self._prefill = make_prefill_into_slot_step(mcfg, scfg,
                                                        seq=self.max_len)
        self._draft = make_draft_step(mcfg, scfg, batch=self.slots)
        self._device_steps = {"prefill_into_slot": 0, "prefill_chunk": 0,
                              "decode": 0, "draft": 0, "verify": 0,
                              "adapter_insert": 0}
        self._signature_steps: dict[str, dict[str, int]] = {
            "decode": {}, "verify": {}}
        # -- host mirror of the block pool (paged only) --------------------
        # The engine owns the free list and the per-slot block lists,
        # mirrors them into the int32 table and writes the table to the
        # device before a device step that reads the cache.
        if self._paged:
            # pop() hands out ascending ids; freed blocks return LIFO.
            self._free: list[int] = list(range(self._n_blocks - 1, -1, -1))
            self._blocks: list[list[int]] = [[] for _ in range(self.slots)]
            self._pages_np = np.full((self.slots, self._max_blocks), -1,
                                     np.int32)
            self._pages_dirty = False
            self._peak_used = 0
        # (slot-handle layout, groups, stacked tree) of the last grouped
        # step: restacked only when the layout changes, never per token.
        self._grouping_cache: tuple | None = None
        # -- dynamic fleet stack (dynamic_grouping=True) --------------------
        # K = slots positions; a position is claimed per DISTINCT handle
        # (refcounted across the slots sharing it) and recycled at the last
        # release. Distinct handles <= occupied slots <= slots, so the free
        # list never runs dry when a seating slot claims one.
        self._dynamic = bool(dynamic_grouping)
        self.max_active_per_adapter = (
            None if max_active_per_adapter is None
            else int(max_active_per_adapter))
        self._dyn_stack = None               # leaves [n_scan, K, ...]
        self._dyn_pos: dict[AdapterHandle, list] = {}   # handle→[pos, refs]
        self._dyn_free: list[int] = list(range(self.slots - 1, -1, -1))
        self._dyn_idx_np = np.zeros((self.slots,), np.int64)
        self._dyn_idx_cached = None          # device mirror of _dyn_idx_np
        self._stack_inserts = 0
        self._slots: list[_Slot] = [_Slot(idx=i) for i in range(self.slots)]
        self._queue: deque[EngineRequest] = deque()
        self._results: dict[int, RequestResult] = {}
        self._next_id = 0
        self._steps = 0
        self._decode_steps = 0
        self._prefills = 0
        self._admitted = 0
        self._retired = 0
        self._generated = 0
        self._slot_steps = 0
        self._draft_steps = 0
        self._verify_steps = 0
        self._accepted_drafts = 0
        self._preemptions = 0
        self._timeouts = 0
        self._quarantined = 0
        self._busy_rejections = 0
        self._spec_disables = 0
        self._spec_reenables = 0
        self._injected_nans = 0
        self._forced_evictions = 0
        self._stale_injected = 0
        self._slow_ticks = 0
        self._nan_tick: tuple = ()     # this tick's poisoned slots
        self._stale_pending = False    # next admission gets a stale handle
        self._spec_rates: list[float] = []   # recent per-tick accept rates
        self._spec_cooldown = 0        # plain ticks left before re-enable
        # -- observability -------------------------------------------------
        # The recorder only receives host scalars the scheduler already
        # holds; untraced, every emit is one attribute check. The cache's
        # spill/reload hook is claimed only when tracing.
        self.trace = trace
        if trace is not None and adapter_cache is not None:
            adapter_cache.on_event = self._cache_event

    # -- observability -------------------------------------------------------

    def _emit(self, name: str, *, rid: int | None = None,
              slot: int | None = None, **data) -> None:
        """Record one lifecycle event (nothing untraced). Every argument is
        host state: this path adds no device work."""
        if self.trace is not None:
            self.trace.emit(name, tick=self._steps, request_id=rid,
                            slot=slot, **data)

    def _cache_event(self, kind: str, key) -> None:
        """The adapter cache's tier-traffic hook: ``spill`` and ``reload``
        events land on the engine's trace at the current tick."""
        self._emit(kind, adapter=key.adapter_id, version=key.version)

    # -- submission ---------------------------------------------------------

    def check_request(self, prompt, *, adapter: AdapterHandle | str | None = None,
                      max_new_tokens: int):
        """Validate a request WITHOUT queuing it: raises exactly what
        :meth:`submit` would and returns the (normalized prompt, resolved
        handle) pair it would queue. Batch front ends run this over every
        request before the first submit, so a bad request in the middle
        of a batch fails the call instead of stranding queued ones."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        P = prompt.shape[0]
        if P < 1:
            raise ValueError("empty prompt")
        if P + 1 > self.max_len:
            raise ValueError(
                f"prompt length {P} leaves no room to generate within "
                f"max_len={self.max_len} (need P + 1 <= max_len)")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens={max_new_tokens} < 1")
        if adapter is None:
            if self.adapters is None:
                raise ValueError(
                    "this engine routes requests through an adapter cache; "
                    "every request must carry an adapter id or handle")
            return prompt, None
        if self.adapter_cache is None:
            raise ValueError(
                "this engine serves one fixed adapter tree; requests "
                "cannot carry adapter handles (construct the engine "
                "with adapter_cache= to route per-request adapters)")
        cache = self.adapter_cache
        handle = (adapter if isinstance(adapter, AdapterHandle)
                  else cache.current_handle(adapter))
        # Backpressure before the resolution: while the LRU thrashes, a
        # COLD current-version request would cost one more precompute and
        # evict another tenant, so it is refused with a retry hint. Stale
        # or unregistered handles fall through to get_state and keep
        # their own errors; a spilled state costs a reload, not a
        # precompute, and is never refused.
        if (cache.thrashing() and not cache.is_resident(handle)
                and not cache.is_spilled(handle)):
            try:
                cur = cache.current_handle(handle.adapter_id)
            except KeyError:
                cur = None
            if cur == handle:
                self._busy_rejections += 1
                self._emit("busy_rejected", adapter=handle.adapter_id,
                           version=handle.version,
                           retry_after=cache.thrash_window)
                raise EngineBusy(
                    f"adapter-state cache is thrashing (last "
                    f"{cache.thrash_window} lookups were all evicting "
                    f"misses) and {handle.adapter_id!r}@v{handle.version} "
                    f"is not resident — admitting it would evict yet "
                    f"another tenant; retry in ~{cache.thrash_window} "
                    f"ticks", retry_after=cache.thrash_window)
        # Submit is the pin point: a stale handle, or a cold state under
        # warm-only routing, fails here, before anything is queued.
        cache.get_state(self.params, handle, allow_miss=self.allow_miss)
        return prompt, handle

    def submit(self, prompt, *, adapter: AdapterHandle | str | None = None,
               max_new_tokens: int, eos_id: int | None = None,
               key_id: int | None = None, priority: int = 0,
               deadline_ticks: int | None = None) -> int:
        """Queue one request; returns its request id. ``adapter``: an
        :class:`AdapterHandle`, a registered adapter id (resolved to the
        CURRENT version now), or None on a single-tenant engine; the
        resolved serving tree is pinned on the request here. ``key_id``:
        the id of this request's sampling stream at ``temperature > 0``
        (default: the request id). ``priority``: higher admits first and
        may PREEMPT a lower-priority slot when no slot is free (the victim
        re-queues as a continuation). ``deadline_ticks``: the request
        expires that many engine steps from now, queued or mid-decode, and
        retires with ``finish_reason="timeout"`` and whatever tokens it
        generated."""
        if deadline_ticks is not None and deadline_ticks < 1:
            raise ValueError(f"deadline_ticks={deadline_ticks} < 1")
        prompt, handle = self.check_request(prompt, adapter=adapter,
                                            max_new_tokens=max_new_tokens)
        state = (self.adapters if handle is None
                 else self.adapter_cache.get_state(
                     self.params, handle, allow_miss=self.allow_miss))
        rid = self._next_id
        self._next_id += 1
        self._queue.append(EngineRequest(
            rid, prompt, handle, int(max_new_tokens), eos_id,
            key_id=rid if key_id is None else int(key_id), state=state,
            priority=int(priority),
            deadline_step=(None if deadline_ticks is None
                           else self._steps + int(deadline_ticks))))
        self._emit("submitted", rid=rid, prompt_len=int(prompt.shape[0]),
                   max_new_tokens=int(max_new_tokens),
                   adapter=(None if handle is None else handle.adapter_id),
                   priority=int(priority), deadline_ticks=deadline_ticks)
        self._emit("queued", rid=rid, depth=len(self._queue))
        return rid

    # -- scheduling ---------------------------------------------------------

    def has_work(self) -> bool:
        return bool(self._queue) or any(s.occupied for s in self._slots)

    def stats(self) -> EngineStats:
        return EngineStats(slots=self.slots, steps=self._steps,
                           decode_steps=self._decode_steps,
                           prefills=self._prefills,
                           admitted=self._admitted, retired=self._retired,
                           generated_tokens=self._generated,
                           slot_steps=self._slot_steps,
                           draft_steps=self._draft_steps,
                           verify_steps=self._verify_steps,
                           accepted_drafts=self._accepted_drafts,
                           stack_inserts=self._stack_inserts,
                           preemptions=self._preemptions,
                           timeouts=self._timeouts,
                           quarantined=self._quarantined,
                           busy_rejections=self._busy_rejections,
                           spec_disables=self._spec_disables,
                           spec_reenables=self._spec_reenables,
                           injected_nans=self._injected_nans,
                           forced_evictions=self._forced_evictions,
                           stale_injected=self._stale_injected,
                           slow_ticks=self._slow_ticks)

    def device_steps(self) -> dict:
        """How many times each device step ran: "prefill_into_slot"
        (rectangular admissions), "prefill_chunk" (paged chunks),
        "decode", the speculative "draft" and "verify", and
        "adapter_insert" (writes of a state into the dynamic stack). A
        paged engine launches K8 twice per layer in each chunk, decode,
        draft and verify step."""
        return dict(self._device_steps)

    def step_signatures(self) -> dict:
        """The group signatures each grouped step kind ran under, with
        the number of steps run under each: {"decode": {str(sig): steps},
        "verify": {str((sig, window)): steps}}. ``sig`` is ``None`` for
        one distinct adapter (and on a single-tenant engine), the
        run-length ``(start, size)`` groups of a static engine, or
        ``"dynamic"``; the host-side counterpart of the reference's
        executables per signature in ``compile_counts()``."""
        return {k: dict(v) for k, v in self._signature_steps.items()}

    # -- block pool (paged K/V) ---------------------------------------------

    def pool_stats(self) -> dict:
        """Host-mirror block-pool accounting (paged engines only). After
        the engine drains, ``used_blocks == 0``."""
        if not self._paged:
            raise ValueError("pool_stats() requires a paged engine "
                             "(construct with paged=True)")
        used = self._n_blocks - len(self._free)
        return {"block_size": self._block_size,
                "n_blocks": self._n_blocks,
                "max_blocks": self._max_blocks,
                "prefill_chunk": self._chunk,
                "free_blocks": len(self._free),
                "used_blocks": used,
                "peak_used_blocks": self._peak_used,
                "per_slot_blocks": [len(b) for b in self._blocks]}

    def _ensure_blocks(self, idx: int, upto_len: int) -> bool:
        """Grow slot ``idx``'s block list until it covers K/V positions
        [0, upto_len); False (the partial growth kept) when the pool runs
        dry."""
        need = -(-upto_len // self._block_size)
        blocks = self._blocks[idx]
        while len(blocks) < need:
            if not self._free:
                return False
            b = self._free.pop()
            self._pages_np[idx, len(blocks)] = b
            blocks.append(b)
            self._pages_dirty = True
        used = self._n_blocks - len(self._free)
        if used > self._peak_used:
            self._peak_used = used
        return True

    def _free_tail(self, idx: int, new_len: int) -> None:
        """Return every block of slot ``idx`` past position ``new_len`` to
        the pool. A freed block's stale content is harmless wherever it is
        reallocated: a slot receives a block only when its frontier
        crosses into it, so every stale position lies at or past the new
        owner's causal frontier until it is overwritten."""
        keep = -(-new_len // self._block_size)
        blocks = self._blocks[idx]
        while len(blocks) > keep:
            b = blocks.pop()
            self._pages_np[idx, len(blocks)] = -1
            self._free.append(b)
            self._pages_dirty = True

    def _free_all(self, idx: int) -> None:
        self._free_tail(idx, 0)

    def _flush_pages(self) -> None:
        """Write the host block table to the device as a FRESH tensor
        (a device step still in flight may read the old one), before every
        device step that reads the cache."""
        if not self._pages_dirty:
            return
        self.cache["pages"] = torch.as_tensor(self._pages_np.copy(),
                                              device=self.device)
        self._pages_dirty = False

    def _block_victim(self) -> int | None:
        """Reclaim order under pool exhaustion: lowest priority first,
        most recently admitted among equals, highest slot index last."""
        occ = [i for i, s in enumerate(self._slots) if s.occupied]
        if not occ:
            return None
        return min(occ, key=lambda i: (self._slots[i].req.priority,
                                       -self._slots[i].admitted_step, -i))

    def _ensure_active_blocks(self, rows: list[int], extra: int
                              ) -> list[int]:
        """Allocate so every row in ``rows`` can write K/V positions
        pos..pos+extra-1 this tick, preempting :meth:`_block_victim` slots
        while the pool is exhausted. Returns the rows still active (a row
        preempted as its own victim drops out)."""
        for i in rows:
            slot = self._slots[i]
            while slot.active and not self._ensure_blocks(i, slot.pos + extra):
                victim = self._block_victim()
                if victim is None:     # unreachable: row i itself is occupied
                    raise RuntimeError(
                        "paged block pool exhausted with nothing to preempt")
                self._preempt(victim)
        return [i for i in rows if self._slots[i].active]

    def _sample_rows(self, logits_rows, key_ids_and_counts) -> list[int]:
        """One token per row from the fetched host logits: the argmax, or
        at ``temperature > 0`` a draw from the request's own generator."""
        if self.temperature <= 0.0:
            return [int(np.argmax(row)) for row in logits_rows]
        out = []
        for row, (kid, n) in zip(logits_rows, key_ids_and_counts):
            seed = int(np.random.SeedSequence(
                [self.seed, kid, n]).generate_state(1)[0])
            gen = torch.Generator().manual_seed(seed)
            probs = torch.softmax(
                torch.as_tensor(row, dtype=torch.float64)
                / self.temperature, dim=-1)
            out.append(int(torch.multinomial(probs, 1, generator=gen)))
        return out

    def _fetch(self, logits) -> np.ndarray:
        """The per-step read-back: fp32 host logits."""
        return logits.float().cpu().numpy()

    def _resolve_state(self, req: EngineRequest):
        if req.adapter is None:
            return self.adapters
        return self.adapter_cache.get_state(self.params, req.adapter,
                                            allow_miss=self.allow_miss)

    def _release(self, slot: _Slot) -> None:
        """Empty ``slot``: its blocks back to the pool (paged) and its
        fleet-stack claim released (dynamic)."""
        if self._paged:
            self._free_all(slot.idx)
        if self._dynamic and slot.handle is not None:
            self._dyn_release(slot.handle)
        slot.req = None
        slot.handle = None
        slot.state = None
        slot.generated = []
        slot.prefilling = False

    def _finish(self, slot: _Slot, reason: str) -> None:
        req = slot.req
        # A preempted-and-resumed request reports its ORIGINAL prompt, the
        # full token stream and its FIRST admission step.
        prefix = [] if req.prefix is None else list(req.prefix)
        self._results[req.request_id] = RequestResult(
            request_id=req.request_id,
            prompt=(req.prompt if req.orig_prompt is None
                    else req.orig_prompt),
            tokens=np.asarray(prefix + slot.generated, np.int32),
            finish_reason=reason,
            admitted_step=(slot.admitted_step if req.first_admitted is None
                           else req.first_admitted),
            finished_step=self._steps, preempted=req.preempted)
        self._emit("terminal", rid=req.request_id, slot=slot.idx,
                   reason=reason,
                   n_tokens=len(prefix) + len(slot.generated))
        if reason == "timeout":
            self._timeouts += 1
        elif reason == "error_numeric":
            self._quarantined += 1
        self._retired += 1
        self._release(slot)

    def _note_token(self, slot: _Slot, tok: int, on_token) -> str | None:
        """Record one sampled token; returns the finish reason if the
        request is now done."""
        slot.generated.append(tok)
        slot.budget -= 1
        slot.last_token = tok
        self._generated += 1
        self._emit(("first_token"
                    if slot.n_prior + len(slot.generated) == 1
                    else "token"),
                   rid=slot.req.request_id, slot=slot.idx, token=tok)
        if on_token is not None:
            on_token(slot.req.request_id, tok)
        if slot.req.eos_id is not None and tok == slot.req.eos_id:
            return "eos"
        if slot.budget <= 0:
            return slot.finish_cap
        return None

    def _error_result(self, req: EngineRequest, e: Exception) -> None:
        """Finish a request whose late resolution failed with
        ``finish_reason="error"``: it is dropped, and admission moves on."""
        res = RequestResult(
            request_id=req.request_id,
            prompt=(req.prompt if req.orig_prompt is None
                    else req.orig_prompt),
            tokens=np.asarray(
                [] if req.prefix is None else list(req.prefix), np.int32),
            finish_reason="error",
            admitted_step=(self._steps if req.first_admitted is None
                           else req.first_admitted),
            finished_step=self._steps, error_type=type(e).__name__,
            error_message=str(e), preempted=req.preempted)
        res._live_error = e
        self._results[req.request_id] = res
        self._emit("terminal", rid=req.request_id, reason="error",
                   error_type=type(e).__name__)

    def _timeout_queued(self, req: EngineRequest) -> None:
        """Retire a QUEUED request whose deadline expired; it reports
        whatever earlier legs generated."""
        self._results[req.request_id] = RequestResult(
            request_id=req.request_id,
            prompt=(req.prompt if req.orig_prompt is None
                    else req.orig_prompt),
            tokens=np.asarray(
                [] if req.prefix is None else list(req.prefix), np.int32),
            finish_reason="timeout",
            admitted_step=(self._steps if req.first_admitted is None
                           else req.first_admitted),
            finished_step=self._steps, preempted=req.preempted)
        self._emit("terminal", rid=req.request_id, reason="timeout",
                   queued=True)
        self._timeouts += 1

    def _apply_tick_faults(self) -> None:
        """Consult the fault plan once at the top of the tick (nothing
        without a plan): a ``slow`` event sleeps now, ``evict``
        invalidates the adapter cache (pinned states untouched), and
        ``stale`` and ``nan`` arm what admission and sampling consume."""
        plan = self.fault_plan
        self._nan_tick = ()
        if plan is None:
            return
        d = plan.slow_at(self._steps)
        if d > 0:
            time.sleep(d)
            self._slow_ticks += 1
            self._emit("fault", kind="slow", seconds=d)
        if plan.evict_at(self._steps) and self.adapter_cache is not None:
            self.adapter_cache.invalidate()
            self._forced_evictions += 1
            self._emit("fault", kind="evict")
        if plan.stale_at(self._steps):
            self._stale_pending = True
            self._emit("fault", kind="stale")
        self._nan_tick = plan.nan_slots(self._steps)
        if self._nan_tick:
            self._emit("fault", kind="nan",
                       slots=[(-1 if t is None else int(t))
                              for t in self._nan_tick])

    def _nan_targets(self, rows: list[int]) -> list[int]:
        """Which of ``rows`` this tick's plan poisons (None = all)."""
        if not self._nan_tick:
            return []
        if any(t is None for t in self._nan_tick):
            return list(rows)
        return [i for i in rows if i in self._nan_tick]

    def _poison(self, rows: list[int], logits_np: np.ndarray) -> np.ndarray:
        """Overwrite the planned rows with NaN on a copy of the host
        logits; the no-fault path makes no copy."""
        targets = self._nan_targets(rows)
        if not targets:
            return logits_np
        logits_np = np.array(logits_np)
        for i in targets:
            logits_np[i] = np.nan
            self._injected_nans += 1
        return logits_np

    def _expire_deadlines(self) -> None:
        """Retire every request, queued or mid-decode, whose absolute
        deadline step has arrived."""
        if any(r.deadline_step is not None and self._steps >= r.deadline_step
               for r in self._queue):
            keep: deque[EngineRequest] = deque()
            for req in self._queue:
                if (req.deadline_step is not None
                        and self._steps >= req.deadline_step):
                    self._timeout_queued(req)
                else:
                    keep.append(req)
            self._queue = keep
        for slot in self._slots:
            if (slot.occupied and slot.req.deadline_step is not None
                    and self._steps >= slot.req.deadline_step):
                self._finish(slot, "timeout")

    def _adapter_eligible(self, req: EngineRequest) -> bool:
        """``max_active_per_adapter``: a request waits in the queue,
        keeping its position, while its adapter already holds that many
        slots. No limit (or a single-tenant engine): always True."""
        if self.max_active_per_adapter is None or req.adapter is None:
            return True
        n = sum(1 for s in self._slots
                if s.occupied and s.handle is not None
                and s.handle.adapter_id == req.adapter.adapter_id)
        return n < self.max_active_per_adapter

    def _pop_next(self) -> EngineRequest | None:
        """Pop the highest-priority ELIGIBLE queued request, the earliest
        submitted among equals (an all-default-priority queue stays FIFO);
        None when every queued request is held by
        ``max_active_per_adapter``."""
        best = -1
        for j, r in enumerate(self._queue):
            if not self._adapter_eligible(r):
                continue
            if best < 0 or r.priority > self._queue[best].priority:
                best = j
        if best < 0:
            return None
        if best == 0:
            return self._queue.popleft()
        self._queue.rotate(-best)
        req = self._queue.popleft()
        self._queue.rotate(best)
        return req

    def _preempt(self, idx: int) -> None:
        """Displace slot ``idx``: re-queue its request as a CONTINUATION
        whose prompt is prompt + generated-so-far, which re-admission
        prefills again; the sampling stream continues through n_prior. A
        slot still MID-ADMISSION (paged) re-queues its request unchanged
        and returns its reserved blocks."""
        slot = self._slots[idx]
        req = slot.req
        self._emit("preempted", rid=req.request_id, slot=idx,
                   mid_admission=slot.prefilling,
                   n_generated=len(slot.generated))
        if slot.prefilling:
            self._queue.append(dataclasses.replace(
                req, preempted=req.preempted + 1))
        else:
            gen = np.asarray(slot.generated, np.int32)
            self._queue.append(dataclasses.replace(
                req,
                prompt=np.concatenate([req.prompt, gen]),
                max_new_tokens=slot.budget,
                prefix=(gen if req.prefix is None
                        else np.concatenate([req.prefix, gen])),
                orig_prompt=(req.prompt if req.orig_prompt is None
                             else req.orig_prompt),
                resume_cap=slot.finish_cap,
                first_admitted=(slot.admitted_step
                                if req.first_admitted is None
                                else req.first_admitted),
                preempted=req.preempted + 1))
        self._preemptions += 1
        self._release(slot)

    def _set_budget(self, slot: _Slot, req: EngineRequest, P: int) -> None:
        """Token budget: the request's own cap, or the cache bound
        (P + budget - 1 decode writes stay below max_len). A continuation
        keeps its ORIGINAL cap label."""
        room = self.max_len - P
        slot.budget = min(req.max_new_tokens, room)
        slot.finish_cap = (req.resume_cap if req.resume_cap is not None
                           else ("length" if req.max_new_tokens <= room
                                 else "max_len"))

    def _first_token(self, slot: _Slot, logits, on_token) -> None:
        """Sample a completed admission's first token, behind the
        non-finite guard. A ``nan`` event of this tick on the slot poisons
        every admission into it, a request that refills the slot within
        the tick included, as in the reference."""
        req = slot.req
        row = self._fetch(logits)[0]
        if self._nan_targets([slot.idx]):
            row = np.full_like(row, np.nan)
            self._injected_nans += 1
        if not np.isfinite(row).all():
            self._emit("quarantined", rid=req.request_id, slot=slot.idx,
                       at="admission")
            self._finish(slot, "error_numeric")
            return
        tok = self._sample_rows([row], [(req.key_id, slot.n_prior)])[0]
        reason = self._note_token(slot, tok, on_token)
        if reason is not None:
            self._finish(slot, reason)

    def _seat(self, idx: int, slot: _Slot, req: EngineRequest,
              state) -> None:
        slot.req = req
        slot.handle = req.adapter
        slot.state = state
        slot.admitted_step = self._steps
        slot.n_prior = 0 if req.prefix is None else int(req.prefix.shape[0])
        slot.generated = []

    def _admit_into(self, idx: int, slot: _Slot, req: EngineRequest,
                    on_token) -> bool:
        """One admission. Rectangular: prefill INTO slot ``idx`` and sample
        the first token (a one-token budget retires here without taking a
        decode row). Paged: SEAT the request, reserving blocks for the
        whole prompt and the first decode write, and mark the slot
        ``prefilling``; :meth:`_chunk_tick` streams the prompt in and its
        final chunk samples the first token. A late resolution that fails
        finishes the request with ``"error"``. Returns False only when a
        paged admission is DEFERRED (the pool cannot hold the prompt now:
        the request goes back to the queue head and this tick admits no
        more)."""
        if self._stale_pending and req.adapter is not None:
            # Fault injection: a handle one version past the registry's,
            # pinned state stripped, so the resolution below raises the
            # cache's REAL stale error.
            self._stale_pending = False
            self._stale_injected += 1
            req = dataclasses.replace(
                req, adapter=dataclasses.replace(
                    req.adapter, version=req.adapter.version + 1),
                state=None)
        try:
            state = (req.state if req.state is not None
                     else self._resolve_state(req))
        except Exception as e:
            self._error_result(req, e)
            return True
        P = req.prompt.shape[0]
        if self._paged:
            need = -(-(P + 1) // self._block_size)
            if len(self._free) < need:
                self._queue.appendleft(req)
                return False
            self._seat(idx, slot, req, state)
            if self._dynamic:
                self._dyn_assign(idx, req.adapter, state)
            slot.pos = 0
            slot.prefilling = True
            slot.chunk_next = 0
            self._ensure_blocks(idx, P + 1)
            self._emit("admitted", rid=req.request_id, slot=idx,
                       prompt_len=P, paged=True)
            if req.preempted:
                self._emit("resumed", rid=req.request_id, slot=idx,
                           attempt=req.preempted)
            return True
        if self._dynamic:
            # Claim the stack position BEFORE the prefill: a one-token
            # request that retires inside this admission releases a
            # position it really held.
            self._dyn_assign(idx, req.adapter, state)
        toks = np.zeros((1, self.max_len), np.int64)
        toks[0, :P] = req.prompt
        logits, self.cache = self._prefill(
            self.params, state, self.cache,
            {"tokens": torch.as_tensor(toks, device=self.device),
             "prompt_len": P, "slot": idx})
        self._device_steps["prefill_into_slot"] += 1
        self._prefills += 1
        self._admitted += 1
        self._seat(idx, slot, req, state)
        self._emit("admitted", rid=req.request_id, slot=idx, prompt_len=P)
        if req.preempted:
            self._emit("resumed", rid=req.request_id, slot=idx,
                       attempt=req.preempted)
        slot.pos = P    # first decode K/V write lands at P
        self._set_budget(slot, req, P)
        self._first_token(slot, logits, on_token)
        return True

    def _admit(self, on_token=None) -> None:
        """Fill free slots from the queue (highest priority first, FIFO
        among equals, skipping requests held by
        ``max_active_per_adapter``), then preempt: while an ELIGIBLE
        queued request outranks the lowest-priority OCCUPIED slot and no
        slot is free, that victim is displaced and the fill loop seats the
        outranking request in its row. A paged admission deferred on block
        exhaustion stops the tick's admitting (head-of-line)."""
        while True:
            for idx, slot in enumerate(self._slots):
                while not slot.occupied and self._queue:
                    req = self._pop_next()
                    if req is None:
                        break   # every queued request is rate-limited
                    if not self._admit_into(idx, slot, req, on_token):
                        return
            if not self._queue:
                return
            elig = [r.priority for r in self._queue
                    if self._adapter_eligible(r)]
            if not elig:
                return
            best = max(elig)
            occupied = [i for i, s in enumerate(self._slots) if s.occupied]
            if not occupied:
                return
            victim = min(occupied,
                         key=lambda i: (self._slots[i].req.priority, i))
            if best <= self._slots[victim].req.priority:
                return
            self._preempt(victim)

    # -- fleet grouping ------------------------------------------------------

    def _dyn_assign(self, idx: int, handle, state) -> None:
        """Give slot ``idx`` a stack position for ``handle``: slots sharing
        a handle share its position (refcounted); a NEW handle claims a
        free position and its state is copied there (the one device copy
        per seating; decode ticks never restack). The stack is built on
        first use as zeros of the state's grouped leaves, [n_scan, slots,
        ...]: finite rows that no live row indexes."""
        ent = self._dyn_pos.get(handle)
        if ent is not None:
            ent[1] += 1
        else:
            pos = self._dyn_free.pop()
            self._dyn_pos[handle] = ent = [pos, 1]
            view = _grouped_view(state)
            if self._dyn_stack is None:
                self._dyn_stack = tree_map(
                    lambda t: torch.zeros((t.shape[0], self.slots)
                                          + tuple(t.shape[1:]),
                                          dtype=t.dtype, device=t.device),
                    view)
            tree_map(lambda big, leaf: big[:, pos].copy_(leaf),
                     self._dyn_stack, view)
            self._device_steps["adapter_insert"] += 1
            self._stack_inserts += 1
        self._dyn_idx_np[idx] = ent[0]
        self._dyn_idx_cached = None

    def _dyn_release(self, handle) -> None:
        """Drop one slot's claim on ``handle``'s position; the LAST claim
        recycles it (its stale row needs no zeroing: no live row's index
        points at it)."""
        ent = self._dyn_pos.get(handle)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            del self._dyn_pos[handle]
            self._dyn_free.append(ent[0])

    def _dyn_idx(self):
        """Device mirror of the per-slot position vector, the decode's
        ``batch_in["adapter_idx"]``; rebuilt only when an admission moved a
        slot's position, never per token. A free slot keeps a stale
        in-range position: its row decodes garbage nothing reads."""
        if self._dyn_idx_cached is None:
            self._dyn_idx_cached = torch.as_tensor(self._dyn_idx_np.copy(),
                                                   device=self.device)
        return self._dyn_idx_cached

    def _slot_grouping(self):
        """(signature, adapter tree) for the CURRENT slot table. A free
        slot is absorbed into the run next to it (its row decodes garbage
        nothing reads), so the signature changes only when the handle
        layout of OCCUPIED slots changes (a paged slot mid-admission
        counts already), and (signature, stacked tree) is cached on that
        layout: a token never triggers a restack."""
        if self.adapter_cache is None:
            return None, self.adapters
        if self._dynamic:
            return "dynamic", self._dyn_stack
        layout = tuple((s.handle if s.occupied else None)
                       for s in self._slots)
        if self._grouping_cache is not None \
                and self._grouping_cache[0] == layout:
            return self._grouping_cache[1], self._grouping_cache[2]
        # The old stack goes before the new one is built: at full width a
        # stacked layout holds several states' bytes.
        self._grouping_cache = None
        keys: list[Any] = list(layout)
        states = {s.handle: s.state for s in self._slots if s.occupied}
        # forward fill from the left, then leading Nones from the right
        last = None
        for i, k in enumerate(keys):
            if k is None:
                keys[i] = last
            else:
                last = k
        nxt = None
        for i in reversed(range(len(keys))):
            if keys[i] is None:
                keys[i] = nxt
            else:
                nxt = keys[i]
        if len(set(keys)) == 1:
            groups, adapters = None, states[keys[0]]
        else:
            runs: list[tuple[Any, int]] = []
            for k in keys:
                if runs and runs[-1][0] == k:
                    runs[-1] = (k, runs[-1][1] + 1)
                else:
                    runs.append((k, 1))
            groups, start = [], 0
            for _, n in runs:
                groups.append((start, n))
                start += n
            groups = tuple(groups)
            adapters = stack_adapter_states(
                [_grouped_view(states[k]) for k, _ in runs], axis=1)
        self._grouping_cache = (layout, groups, adapters)
        return groups, adapters

    # The steps are closures that hold no compiled state, so each call
    # builds the one its group signature needs.

    def _decode(self, params, adapters, cache, batch_in, groups=None):
        """One batched decode under the group signature ``groups``."""
        dyn = groups == "dynamic"
        step = make_decode_step(self.mcfg, self.scfg, batch=self.slots,
                                tenant_groups=None if dyn else groups,
                                dynamic_groups=dyn)
        return step(params, adapters, cache, batch_in)

    def _verify(self, params, adapters, cache, batch_in, groups=None):
        """One speculative verify under ``groups``; its window is the
        width of ``batch_in["tokens"]``."""
        dyn = groups == "dynamic"
        step = make_verify_step(self.mcfg, self.scfg, batch=self.slots,
                                window=int(batch_in["tokens"].shape[1]),
                                tenant_groups=None if dyn else groups,
                                dynamic_groups=dyn)
        return step(params, adapters, cache, batch_in)

    def _count_signature(self, kind: str, key) -> None:
        sigs = self._signature_steps[kind]
        sigs[str(key)] = sigs.get(str(key), 0) + 1

    def _grouped_batch(self, toks: np.ndarray):
        """(signature, adapter tree, batch_in) for a decode or verify over
        ``toks``."""
        groups, adapters = self._slot_grouping()
        batch_in = {"tokens": torch.as_tensor(toks, device=self.device)}
        if groups == "dynamic":
            batch_in["adapter_idx"] = self._dyn_idx()
        return groups, adapters, batch_in

    # -- ticks ---------------------------------------------------------------

    def _quarantine(self, rows: list[int], logits_np: np.ndarray
                    ) -> tuple[list[int], np.ndarray]:
        """Per-row non-finite guard over the fetched host logits ([slots,
        V] from decode, [slots, k + 1, V] from a verify), after the fault
        plan's poison: a row whose logits are not all finite retires with
        ``finish_reason="error_numeric"``; the others go on untouched.
        Returns the surviving rows and the (possibly poisoned) logits."""
        logits_np = self._poison(rows, logits_np)
        flat = logits_np.reshape(logits_np.shape[0], -1)
        bad = [i for i in rows if not np.isfinite(flat[i]).all()]
        for i in bad:
            self._emit("quarantined", rid=self._slots[i].req.request_id,
                       slot=i, at="decode")
            self._finish(self._slots[i], "error_numeric")
        if bad:
            rows = [i for i in rows if self._slots[i].active]
        return rows, logits_np

    def _chunk_tick(self, on_token) -> None:
        """Paged chunked admission: ONE prompt chunk per mid-admission slot
        per tick, under the slot's own pinned state. Chunks start at 0, C,
        2C, ... and the FINAL chunk is re-anchored at P - C (when P > C):
        it overlaps the previous chunk and rewrites those positions with
        the same K/V. The final chunk's last-position logits give the
        first token, and the slot joins decode this tick.

        Between a slot's chunks, the batched decode advances every row's
        device length and writes one garbage K/V row at the admitting
        slot's drifted frontier; the chunk step takes its start from the
        HOST mirror, and the drifted position falls inside the next
        chunk's window, so the garbage is overwritten before it is read."""
        for idx, slot in enumerate(self._slots):
            if not slot.prefilling:
                continue
            req = slot.req
            P = req.prompt.shape[0]
            C = self._chunk
            final = P - slot.chunk_next <= C
            if final:
                c_len = min(P, C)
                start = P - c_len
            else:
                start, c_len = slot.chunk_next, C
            toks = np.zeros((1, C), np.int64)
            toks[0, :c_len] = req.prompt[start:start + c_len]
            self._emit("chunk_prefill", rid=req.request_id, slot=idx,
                       start=start, chunk_len=c_len, final=final)
            self._flush_pages()
            logits, self.cache = self._chunk_prefill(
                self.params, slot.state, self.cache,
                {"tokens": torch.as_tensor(toks, device=self.device),
                 "slot": idx, "start": start, "chunk_len": c_len})
            self._device_steps["prefill_chunk"] += 1
            if not final:
                slot.chunk_next = start + C
                continue
            slot.prefilling = False
            slot.pos = P
            self._prefills += 1
            self._admitted += 1
            self._set_budget(slot, req, P)
            self._first_token(slot, logits, on_token)

    def _decode_tick(self, active: list[int], on_token) -> None:
        """One batched decode over the active slots."""
        if self._paged:
            active = self._ensure_active_blocks(active, 1)
            if not active:
                return
            self._flush_pages()
        toks = np.zeros((self.slots, 1), np.int64)
        for i in active:
            toks[i, 0] = self._slots[i].last_token
        groups, adapters, batch_in = self._grouped_batch(toks)
        logits, self.cache = self._decode(self.params, adapters, self.cache,
                                          batch_in, groups)
        self._device_steps["decode"] += 1
        self._count_signature("decode", groups)
        logits_np = self._fetch(logits)      # the sampling sync
        self._decode_steps += 1
        self._slot_steps += len(active)
        active, logits_np = self._quarantine(active, logits_np)
        toks_out = self._sample_rows(
            [logits_np[i] for i in active],
            [(self._slots[i].req.key_id,
              self._slots[i].n_prior + len(self._slots[i].generated))
             for i in active])
        for i, tok in zip(active, toks_out):
            slot = self._slots[i]
            slot.pos += 1               # this decode wrote K/V at pos
            reason = self._note_token(slot, tok, on_token)
            if reason is not None:
                self._finish(slot, reason)

    def _sync_len(self, lens: np.ndarray) -> None:
        """Set ``cache["len"]`` to the host's per-row lengths: the
        speculative rewind. A fresh tensor every time (``torch.tensor``
        copies), so it aliases neither the host array nor a length a step
        still holds. Free rows get 0: their K/V are garbage either way,
        and an admission fills its row anew."""
        self.cache["len"] = torch.tensor(lens, dtype=torch.int32,
                                         device=self.device)

    def _speculative_ok(self, active: list[int]) -> bool:
        """Whether THIS tick drafts and verifies: greedy sampling only, and
        every active row's k + 1 window must fit under ``max_len``
        (``_write_rows`` would clamp a window past the end and shift that
        row's writes without failing). Paged: no slot mid-admission (the
        drafts would advance its device length past what its next chunk
        rewrites), and the pool must back every row's whole window now;
        when it cannot, the tick decodes plainly, which needs at most one
        block a row, and nothing is preempted for speculation.

        The ladder: a tick in the cooldown after a disable decodes
        plainly, and the last tick of the cooldown counts a re-enable."""
        if self.speculative_k <= 0 or self.temperature > 0.0:
            return False
        if self._spec_cooldown > 0:
            self._spec_cooldown -= 1
            if self._spec_cooldown == 0:
                self._spec_reenables += 1
                self._emit("spec_reenabled")
            return False
        k = self.speculative_k
        if not all(self._slots[i].pos + k + 1 <= self.max_len
                   for i in active):
            return False
        if self._paged:
            if any(s.prefilling for s in self._slots):
                return False
            if not all(self._ensure_blocks(i, self._slots[i].pos + k + 1)
                       for i in active):
                return False
        return True

    def _speculative_tick(self, active: list[int], on_token) -> None:
        """Draft k base-only tokens a row, verify the k + 1 window in one
        forward through the adapted path (grouped like decode), accept
        each row's longest matching prefix and rewind its length to the
        accepted frontier.

        The drafts write base-path K/V at pos..pos+k-1; the verify starts
        again at pos and overwrites pos..pos+k with full-path K/V, so no
        committed token ever attends to base-path K/V. Past a row's new
        frontier the K/V are stale, and the causal mask hides them until
        they are overwritten."""
        k = self.speculative_k
        base_len = np.zeros((self.slots,), np.int32)
        cur = np.zeros((self.slots, 1), np.int64)
        for i in active:
            base_len[i] = self._slots[i].pos
            cur[i, 0] = self._slots[i].last_token

        # -- draft: k greedy base-only tokens a row -------------------------
        self._sync_len(base_len)
        if self._paged:
            self._flush_pages()       # _speculative_ok grew the windows
        drafts = np.zeros((self.slots, k), np.int64)
        for j in range(k):
            logits, self.cache = self._draft(
                self.params, self.cache,
                {"tokens": torch.as_tensor(cur, device=self.device)})
            self._device_steps["draft"] += 1
            lnp = self._fetch(logits)
            self._draft_steps += 1
            for i in active:
                drafts[i, j] = cur[i, 0] = int(np.argmax(lnp[i]))

        # -- verify: one forward over [last token, drafts] ------------------
        self._sync_len(base_len)      # rewind over the drafts' advance
        win = np.zeros((self.slots, k + 1), np.int64)
        for i in active:
            win[i, 0] = self._slots[i].last_token
            win[i, 1:] = drafts[i]
        groups, adapters, batch_in = self._grouped_batch(win)
        logits, self.cache = self._verify(self.params, adapters, self.cache,
                                          batch_in, groups)
        self._device_steps["verify"] += 1
        self._count_signature("verify", (groups, k + 1))
        logits_np = self._fetch(logits)       # [slots, k + 1, V]
        self._verify_steps += 1
        # Quarantine BEFORE acceptance: a poisoned row emits nothing, and
        # its rewind target is 0.
        active, logits_np = self._quarantine(active, logits_np)

        # -- accept the longest matching prefix, then rewind ----------------
        accepted_this = 0
        new_len = np.zeros((self.slots,), np.int32)
        for i in active:
            slot = self._slots[i]
            # true[j]: the token plain decode emits after window position
            # j, valid up to the first draft that misses.
            true = np.argmax(logits_np[i], axis=-1)
            a = 0
            while a < k and drafts[i, a] == true[a]:
                a += 1
            self._accepted_drafts += a
            accepted_this += a
            # The a accepted drafts and the verify's own token (a missed
            # draft's correction, or the token after a whole window).
            for tok in true[:a + 1]:
                slot.pos += 1
                reason = self._note_token(slot, int(tok), on_token)
                if reason is not None:
                    self._finish(slot, reason)
                    break
            if slot.active:
                new_len[i] = slot.pos
        if self._paged:
            # Blocks past each surviving row's frontier (taken for the
            # window) go back to the pool; a finished row freed all of its
            # blocks in _finish.
            for i in active:
                if self._slots[i].active:
                    self._free_tail(i, self._slots[i].pos)
        self._sync_len(new_len)

        # -- the ladder: track the accept rate ------------------------------
        if active and self.spec_accept_floor > 0.0:
            self._spec_rates.append(accepted_this / (k * len(active)))
            if len(self._spec_rates) > self.spec_window:
                self._spec_rates.pop(0)
            if (len(self._spec_rates) == self.spec_window
                    and sum(self._spec_rates) / self.spec_window
                    < self.spec_accept_floor):
                self._spec_cooldown = self.spec_reenable_after
                self._spec_disables += 1
                self._emit("spec_disabled",
                           cooldown=self.spec_reenable_after)
                self._spec_rates.clear()

    def step(self, on_token=None) -> list[RequestResult]:
        """One scheduler tick: apply the fault plan's events, expire
        deadlines, admit into free slots, one chunk per admitting slot
        (paged), then one batched decode, or draft/verify/rewind, over
        every active slot. Returns the requests that FINISHED during this
        tick. ``on_token(request_id, token)`` streams every sampled
        token."""
        before = set(self._results)
        self._apply_tick_faults()
        self._expire_deadlines()
        self._admit(on_token)
        if self._paged:
            self._chunk_tick(on_token)
        active = [i for i, s in enumerate(self._slots) if s.active]
        if active:
            if self._speculative_ok(active):
                self._speculative_tick(active, on_token)
            else:
                self._decode_tick(active, on_token)
        self._nan_tick = ()
        self._steps += 1
        return [self._results[rid]
                for rid in sorted(set(self._results) - before)]

    def run(self, on_token=None) -> list[RequestResult]:
        """Drive :meth:`step` until the queue and slot table drain, then
        hand over (and drop) every undelivered result, by request id."""
        while self.has_work():
            self.step(on_token)
        return self.pop_results()

    def results(self) -> list[RequestResult]:
        """Finished-but-undelivered results, oldest request first."""
        return [self._results[rid] for rid in sorted(self._results)]

    def pop_results(self) -> list[RequestResult]:
        """:meth:`results`, removing them from the engine."""
        out = self.results()
        self._results.clear()
        return out

