"""Serving driver (counterpart of ``repro/launch/serve.py``): precompute the
frozen-adapter state once, prefill the prompt (padded to ``max_len`` for
attention stacks, at its exact length for Mamba stacks), then decode token
by token against the in-place cache.

Runs on the card unless the CPU is asked for explicitly::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --batch 4 --prompt-len 960 --gen-len 32 --rank 384 --alpha 192
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --smoke --device cpu --continuous --paged
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --batch 8 --prompt-len 1024 --gen-len 16 --rank 384 --alpha 192 \\
        --continuous --speculative 3 --trace-out trace.jsonl \\
        --metrics-out metrics.prom
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --smoke --device cpu --continuous --inject nan@3:1,slow@4 \\
        --deadline 40 --priority 1
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --smoke --device cpu --fleet 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
        --batch 4 --prompt-len 960 --gen-len 32 --rank 384 --alpha 192
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-7b \\
        --batch 4 --prompt-len 960 --gen-len 32 --rank 384 --alpha 192
    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-medium \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --tenants 3 --batch 2 --prompt-len 960 --gen-len 32 --rank 384 \\
        --alpha 192
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --smoke --device cpu --tenants 3
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
        --batch 4 --prompt-len 960 --gen-len 32 --rank 384 --alpha 192
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llama4-scout-17b-a16e --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \\
        --smoke --device cpu

``--arch`` takes every arch of ``repro_torch.configs``: qwen2-7b,
falcon-mamba-7b, phi4-mini-3.8b, qwen2-vl-7b, chatglm3-6b, qwen3-32b,
musicgen-medium, qwen2-vl-72b, the MoE qwen2-moe-a2.7b and
llama4-scout-17b-a16e and the hybrid jamba-v0.1-52b (Mamba and NoPE
attention layers, MoE on every other layer; its prefill runs at the
exact prompt length, as every stack with Mamba layers). The prompts are
token ids, for the frontend archs too (their frontends are stubs;
precomputed embeddings go through
``launch/steps.py``'s prefill and decode steps). An MoE stack serves on
the plain path only: its capacity dispatch couples a batch's rows, so
``--continuous``, ``--fleet`` and ``--tenants`` refuse it, as the
reference's do; its padded prefill computes the experts' capacity from
the padded length, as the reference's does.

``--continuous`` serves 2 x ``--batch`` mixed-length requests for one
registered tenant through :class:`EngineServer` (``--batch`` slots of the
continuous-batching engine, ``launch/engine.py``, over an adapter-state
cache): ``--paged`` with its block-paged K/V cache and chunked prefill,
``--speculative K`` drafting K base-model tokens a tick, ``--inject``
a fault plan, ``--deadline N`` and ``--priority N``. ``--fleet N``
serves ``max(2 x --batch, N)`` requests over N tenants through the
dynamic-grouping engine, then the static one. ``--trace-out`` and
``--metrics-out`` write the traced engine's lifecycle (JSONL or Chrome
trace) and metrics (Prometheus text).

The CLI's oracles: the paged, fleet and speculative runs are each served
again by their plain counterpart (a rectangular, a static-grouping, a
non-speculative engine) and their greedy streams compared. In fp32 (the
``--smoke`` configs) the streams must be equal and the CLI asserts it. In
bf16 the two engines round differently (chunked prefill against one
prefill, per-group against all-tenant products, a verify window against a
decode step), so random-weight streams part after a few tokens (on an
H100 at qwen2-7b's full width, 3 of 24 streams of 64 tokens stayed equal
across the fleet groupings and 1 of 24 with speculation): the CLI prints
how many of the streams are equal.

``--tenants N`` registers N adapter sets with an :class:`~repro_torch.
core.adapter_cache.AdapterStateCache` and serves ``--batch`` requests
for each in ONE batch through :class:`MultiTenantServer`: the per-tenant
states are precomputed on their first request (K1 with its epilogue once
per adapted module), stacked, and every row takes its own tenant's
folded state (``repro_torch.core.adapter.dora_linear_grouped``). Each
tenant's adapters are a fresh DoRA init (B = 0), as in the reference's
CLI, so the tenants serve the same tokens here.

Weights are random, drawn from ``--seed`` on the serving device.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import time
from collections import OrderedDict
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import probes
from repro_torch.configs import get_config
from repro_torch.core.adapter import stack_adapter_states
from repro_torch.core.adapter_cache import (AdapterHandle, AdapterStateCache,
                                            mesh_fingerprint)
from repro_torch.core.config import DoRAConfig
from repro_torch.launch.sharding import local_rows
from repro_torch.launch.steps import (PhaseClock, StepConfig,
                                      check_serving_layout, make_decode_step,
                                      make_precompute_step,
                                      make_prefill_step)
from repro_torch.models.lm import init_adapters, init_params


def resolve_device(device=None) -> torch.device:
    """None means the card: it must be there, and nothing falls back to
    the CPU. ``"cpu"`` is the explicit CPU request."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        probes.require_cuda(dev.index or 0)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_cache_mesh(cache: AdapterStateCache, mesh) -> None:
    """The cache keys states on the mesh they were computed and laid out
    for (``mesh_fingerprint``); serving them under another mesh would
    serve shards of another layout. Refused."""
    want = mesh_fingerprint(mesh)
    if cache.sharding != want:
        raise ValueError(
            f"adapter cache is keyed for sharding {cache.sharding} but "
            f"serving runs on mesh {want} — build the cache with "
            f"AdapterStateCache.for_serving(mcfg, scfg, mesh) for THIS "
            f"mesh so its states are this layout's shards")


def _sample(last, temperature: float, generator):
    if temperature > 0.0:
        probs = torch.softmax(last.float() / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
    else:
        nxt = torch.argmax(last, dim=-1)
    return nxt[:, None]


class _Rows:
    """How a mesh's ranks split the batch rows: each data replica runs its
    rows ([B / data, ...]), and every rank samples the whole batch from
    the logits gathered over the data axes."""

    def __init__(self, lay):
        self.lay = lay

    def local(self, t):
        return t[local_rows(self.lay.mesh, t.shape[0])]

    def gather(self, logits):
        from repro_torch.core.sharding import all_gather
        lay = self.lay
        return all_gather(logits.contiguous(), lay.dp_axes, lay.mesh, 0,
                          tag="generate.logits")


def _decode_loop(prefill, decode, params, adapters, toks, *, prompt_len,
                 gen_len, pad, temperature, seed, collect_logits=False,
                 clock: PhaseClock | None = None, rows: _Rows | None = None):
    """The prefill → sample → decode loop. Returns (tokens [B, P+gen_len],
    the logits each sampled token was drawn from, or None). ``rows``:
    under a mesh the steps take this replica's rows of the batch, and
    every rank samples the whole batch."""
    clock = clock or PhaseClock(None, toks.device)
    local = (lambda t: t) if rows is None else rows.local
    gather = (lambda t: t) if rows is None else rows.gather
    P = prompt_len
    batch_in = {"tokens": local(toks)}
    if pad:
        batch_in = {"tokens": torch.nn.functional.pad(local(toks), (0, pad)),
                    "prompt_len": P}
    clock.start()
    logits, cache = prefill(params, adapters, batch_in)
    logits = gather(logits)
    clock.stop("prefill_s")
    # The decode contract: the cache stands at exactly the true prompt
    # length, so the first generated token is written at position P.
    if cache["len"] != P:
        raise RuntimeError(f"prefill left cache at {cache['len']}, "
                           f"expected {P}")
    generator = torch.Generator(device=toks.device).manual_seed(seed)
    out = [toks]
    steps_logits = [] if collect_logits else None
    last = logits
    clock.start()
    for _ in range(gen_len):
        if collect_logits:
            steps_logits.append(last)
        nxt = _sample(last, temperature, generator)
        out.append(nxt)
        last, cache = decode(params, adapters, cache, {"tokens": local(nxt)})
        last = gather(last)
    clock.stop("decode_s")
    return torch.cat(out, dim=1), steps_logits


def generate(mcfg, params, adapters, scfg: StepConfig, prompts, *,
             gen_len: int, max_len: int, temperature: float = 0.0,
             seed: int = 0, cache_adapters: bool = True,
             fold_gsb: bool = False, mesh=None, adapter_cache=None,
             allow_miss: bool = True, return_logits: bool = False,
             device=None, stats: dict | None = None):
    """prompts: int [B, P] (numpy or tensor). Returns tokens [B, P+gen_len]
    (int64, on ``device``), or (tokens, per-step logits) with
    ``return_logits``.

    ``adapters`` is an adapter tree (single tenant), or an
    :class:`~repro_torch.core.adapter_cache.AdapterHandle` resolved
    through ``adapter_cache``. A handle that misses the cache while
    ``allow_miss=False`` is refused with an error naming the key fields,
    and a stale handle (version behind the registry) always is.

    ``device``: None is the card, which must be present (the mesh's
    device when a mesh is given); ``"cpu"`` is the explicit CPU request.
    ``params``/``adapters`` must already live there.
    ``cache_adapters``: precompute the frozen-adapter state (cached g)
    before prefill (a handle's state comes from the cache instead).
    ``fold_gsb``: also fold g·s into B.
    ``mesh`` (``launch/mesh.py``): ``params`` and ``adapters`` are this
    rank's shards (``launch/sharding.py shard_tree``) and ``prompts`` the
    whole batch. The precompute runs on the mesh
    (``make_precompute_step(mcfg, scfg, mesh)``), or a handle resolves
    through a cache built for this mesh
    (``AdapterStateCache.for_serving(mcfg, scfg, mesh)``); each data
    replica prefills (padded, sequence-parallel) and decodes
    (tensor-parallel) its rows; the last logits are gathered over the
    data axes, so every rank samples the whole [B, V] with the same
    generator and returns the whole token matrix: the single-card
    ``generate``'s for the same seed.
    ``stats``: when given, filled with the wall seconds of each phase
    (``precompute_s``: the precompute, or the cache lookup of a handle;
    ``prefill_s``, ``decode_s``), each ended by a device synchronisation;
    under a mesh, this rank's.
    """
    dev = resolve_device(device if device is not None or mesh is None
                         else mesh.device)
    if params["embed"].device != dev:
        raise ValueError(f"params live on {params['embed'].device}, serving "
                         f"was asked on {dev}")
    clock = PhaseClock(stats, dev)
    if isinstance(adapters, AdapterHandle):
        if adapter_cache is None:
            raise ValueError(
                f"generate() was handed the adapter handle {adapters} but "
                f"no adapter_cache to resolve it against")
        _check_cache_mesh(adapter_cache, mesh)
        clock.start()
        adapters = adapter_cache.get_state(params, adapters,
                                           allow_miss=allow_miss)
        clock.stop("precompute_s")
    elif cache_adapters:
        clock.start()
        adapters = make_precompute_step(mcfg, scfg, mesh, fold_gsb=fold_gsb)(
            params, adapters)
        clock.stop("precompute_s")

    toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                           device=dev)
    B, P = toks.shape
    if max_len < P + gen_len:
        raise ValueError(f"max_len={max_len} < P+gen_len={P + gen_len}")
    # Padded prefill (attention-only stacks): one prefill shape per (batch,
    # max_len) serves every prompt length; the step rewinds the cache
    # length to P. A Mamba state integrates every token it sees and cannot
    # rewind, so stacks with Mamba layers prefill at the exact P.
    can_pad = all(k == "attn" for k in mcfg.layer_kinds())
    pad = max_len - P if can_pad else 0
    prefill = make_prefill_step(mcfg, scfg, mesh, batch=B, seq=max_len,
                                padded=bool(pad))
    decode = make_decode_step(mcfg, scfg, mesh, batch=B)
    tokens, logits = _decode_loop(
        prefill, decode, params, adapters, toks, prompt_len=P,
        gen_len=gen_len, pad=pad, temperature=temperature, seed=seed,
        collect_logits=return_logits, clock=clock,
        rows=None if mesh is None else _Rows(decode.layout))
    return (tokens, logits) if return_logits else tokens


# ---------------------------------------------------------------------------
# Multi-tenant request routing.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: a prompt row and the adapter it runs under
    (an :class:`AdapterHandle`, or a bare adapter-id string meaning "the
    current registered version")."""
    prompt: Any                        # int [P]
    adapter: AdapterHandle | str


class MultiTenantServer:
    """Request-routed serving over an :class:`AdapterStateCache`.

    ``serve(requests)`` resolves each request's adapter handle through the
    LRU (precomputing on a miss unless ``allow_miss=False``), sorts the
    batch's rows so same-adapter rows are contiguous (stable, by first
    appearance), and runs ONE prefill + decode loop for the whole batch:

      - one distinct adapter: the single-tenant path, the serve loop of
        :func:`generate` on the cached state;
      - K > 1 adapters: the per-tenant states are stacked leaf-wise
        ([n_scan, K, ...]) and the steps are built for the static group
        signature ((start, size) per tenant); each group's rows take the
        homogeneous gsB path's delta, and no step does norm work.

    Mixed prompt lengths, ``static=False`` and ``speculative_k`` take the
    ENGINE route instead: a cache-routed continuous-batching
    :class:`~repro_torch.launch.engine.DecodeEngine` of ``engine_slots``
    slots, kept per (slots, max_len) (at most two, least recently used
    dropped first: each pins a K/V cache), to which ``dynamic_grouping``,
    ``max_active_per_adapter`` and ``trace`` are handed.

    Step closures are kept per (batch, max_len, pad, groups), at most
    ``max_cached_steps`` of them (least recently used dropped first).

    ``device``: None is the card, which must be present (the mesh's
    device when a mesh is given); ``"cpu"`` is the explicit CPU request;
    ``params`` must live there. ``mesh``: ``params`` are this rank's
    shards and ``cache`` is keyed for this mesh
    (``AdapterStateCache.for_serving(mcfg, scfg, mesh)``), so every state
    and their stack ([n_scan, K, ...], ``launch/sharding.py
    fleet_stack_sharding``) are this rank's shards. Every rank serves the
    same requests: each data replica prefills (padded to ``max_len``,
    which must split over ``model``) and decodes its rows under its share
    of the groups, and every rank samples the whole batch and returns the
    same tokens. The engine route runs ``DecodeEngine(mesh=)``, with
    ``dynamic_grouping`` and ``speculative_k`` as on one card.
    """

    def __init__(self, mcfg, scfg: StepConfig, params, *,
                 cache: AdapterStateCache, mesh=None,
                 max_cached_steps: int = 32, engine_slots: int = 8,
                 dynamic_grouping: bool = False,
                 max_active_per_adapter: int | None = None,
                 trace=None, device=None):
        _check_cache_mesh(cache, mesh)
        self.device = resolve_device(device if device is not None
                                     or mesh is None else mesh.device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"serving was asked on {self.device}")
        self.mesh = mesh
        self.mcfg = mcfg
        self.scfg = scfg
        self.params = params
        self.cache = cache
        self.trace = trace
        self.dynamic_grouping = bool(dynamic_grouping)
        self.max_active_per_adapter = max_active_per_adapter
        self.engine_slots = int(engine_slots)
        self.max_cached_steps = max_cached_steps
        self._steps: OrderedDict = OrderedDict()
        self.max_cached_engines = 2
        self._engines: OrderedDict = OrderedDict()

    def _resolve(self, req: Request) -> AdapterHandle:
        if isinstance(req.adapter, AdapterHandle):
            return req.adapter
        return self.cache.current_handle(req.adapter)

    def _get_steps(self, *, batch: int, max_len: int, pad: bool, groups):
        key = (batch, max_len, pad, groups)
        if key in self._steps:
            self._steps.move_to_end(key)
            return self._steps[key]
        prefill = make_prefill_step(self.mcfg, self.scfg, self.mesh,
                                    batch=batch, seq=max_len, padded=pad,
                                    tenant_groups=groups)
        decode = make_decode_step(self.mcfg, self.scfg, self.mesh,
                                  batch=batch, tenant_groups=groups)
        self._steps[key] = (prefill, decode)
        while len(self._steps) > self.max_cached_steps:
            self._steps.popitem(last=False)
        return self._steps[key]

    def _get_engine(self, *, slots: int, max_len: int, temperature: float,
                    seed: int, allow_miss: bool, speculative_k: int = 0):
        from repro_torch.launch.engine import DecodeEngine
        key = (slots, max_len)
        if key in self._engines:
            self._engines.move_to_end(key)
            eng = self._engines[key]
        else:
            eng = DecodeEngine(self.mcfg, self.scfg, self.params,
                               slots=slots, max_len=max_len,
                               adapter_cache=self.cache, mesh=self.mesh,
                               dynamic_grouping=self.dynamic_grouping,
                               max_active_per_adapter=(
                                   self.max_active_per_adapter),
                               trace=self.trace, device=self.device)
            self._engines[key] = eng
            while len(self._engines) > self.max_cached_engines:
                self._engines.popitem(last=False)
        eng.temperature = float(temperature)
        eng.seed = int(seed)
        eng.allow_miss = allow_miss
        eng.speculative_k = int(speculative_k)
        return eng

    def _serve_continuous(self, requests, prompts, *, gen_len, max_len,
                          temperature, seed, allow_miss, speculative_k=0):
        """The engine route: every request is prefilled into a slot at its
        TRUE prompt length; beyond ``engine_slots`` requests queue and
        join as rows retire. Returns 1-D [P_i + gen_len] arrays in request
        order. Every request is checked before the first submit, so a bad
        one fails the call without stranding others in the persistent
        engine; sampling streams are keyed by the request's index within
        THIS call, so a repeated call reproduces its tokens."""
        eng = self._get_engine(slots=self.engine_slots, max_len=max_len,
                               temperature=temperature, seed=seed,
                               allow_miss=allow_miss,
                               speculative_k=speculative_k)
        results = _serve_on_engine(
            eng, [(p, self._resolve(r)) for r, p in zip(requests, prompts)],
            gen_len=gen_len)
        for res in results:
            if res.finish_reason == "error":
                # A late resolution failed at admission: the engine has
                # already dropped the request, so it is not wedged.
                raise res.error
        return [np.concatenate([p, res.tokens])
                for p, res in zip(prompts, results)]

    def serve(self, requests: Sequence[Request], *, gen_len: int,
              max_len: int, temperature: float = 0.0, seed: int = 0,
              allow_miss: bool = True, return_logits: bool = False,
              static: bool | None = None, speculative_k: int = 0,
              check_contract: bool | None = None,
              stats: dict | None = None):
        """Serve one batch. Same-length batches take the static path and
        return tokens [B, P+gen_len] in REQUEST order (or (tokens,
        per-step logits) with ``return_logits``). Mixed lengths,
        ``static=False`` and ``speculative_k > 0`` take the engine route
        and return a LIST of 1-D [P_i + gen_len] int32 arrays in request
        order; ``static=True`` with mixed lengths keeps the length-bucket
        error. ``return_logits`` and ``check_contract`` are the static
        path's (the port's static loop always checks the cache length).
        ``stats`` (static path): when given, filled with the wall seconds
        of each phase (``precompute_s``: the cache lookups, a precompute
        per miss; ``stack_s`` when K > 1; ``prefill_s``; ``decode_s``),
        each ended by a device synchronisation."""
        if not requests:
            raise ValueError("empty request batch")
        prompts = [np.asarray(r.prompt) for r in requests]
        P = prompts[0].shape[-1]
        mixed = any(p.shape[-1] != P for p in prompts)
        if static is None:
            static = not mixed and not speculative_k
        if static and speculative_k:
            raise ValueError(
                "speculative_k requires the continuous-batching engine "
                "path (its rewindable per-row cache): serve with "
                "static=False/None, not static=True")
        if not static:
            if return_logits:
                raise ValueError(
                    "return_logits is only available on the static path "
                    "(the engine streams per-request tokens instead)")
            if check_contract:
                raise ValueError(
                    "check_contract is only meaningful on the static "
                    "path: the engine schedules on host mirrors and "
                    "never reads cache['len'] back, so there is no "
                    "blocking contract check to enable")
            if any(p.shape[-1] + gen_len > max_len for p in prompts):
                raise ValueError(
                    f"max_len={max_len} < P+gen_len="
                    f"{max(p.shape[-1] for p in prompts) + gen_len}")
            return self._serve_continuous(
                requests, [np.asarray(p, np.int32) for p in prompts],
                gen_len=gen_len, max_len=max_len, temperature=temperature,
                seed=seed, allow_miss=allow_miss,
                speculative_k=speculative_k)
        if mixed:
            raise ValueError(
                f"all prompts in one batch must share a length bucket on "
                f"the static path; got "
                f"{sorted({p.shape[-1] for p in prompts})} — serve with "
                f"static=None/False to admit mixed lengths through the "
                f"continuous-batching engine, or bucket requests by "
                f"prompt length before batching")
        if max_len < P + gen_len:
            raise ValueError(f"max_len={max_len} < P+gen_len={P + gen_len}")
        tp = 1 if self.mesh is None else dict(self.mesh.shape).get("model",
                                                                    1)
        if max_len % tp:
            raise ValueError(
                f"MultiTenantServer(mesh=...) prefills padded to max_len "
                f"and splits it over model={tp}: max_len={max_len} does "
                f"not split; serve with a max_len that is a multiple of "
                f"{tp}")

        # Resolve handles (hit, precompute on a miss, or refuse), then group
        # the rows by adapter: a stable sort by first appearance, so
        # same-adapter rows are contiguous and the grouping signature is
        # deterministic in request order.
        clock = PhaseClock(stats, self.device)
        handles = [self._resolve(r) for r in requests]
        order: dict[AdapterHandle, int] = {}
        for h in handles:
            order.setdefault(h, len(order))
        perm = sorted(range(len(requests)), key=lambda i: order[handles[i]])
        inv = torch.as_tensor(np.argsort(perm), device=self.device)
        clock.start()
        states = {h: self.cache.get_state(self.params, h,
                                          allow_miss=allow_miss)
                  for h in order}
        clock.stop("precompute_s")

        toks = torch.as_tensor(np.stack([prompts[i] for i in perm]),
                               dtype=torch.int64, device=self.device)
        B = toks.shape[0]
        if len(order) == 1:
            adapters = next(iter(states.values()))
            groups = None          # one tenant: the single-tenant path
        else:
            clock.start()
            adapters = stack_adapter_states(
                [states[h] for h in order], axis=1)
            clock.stop("stack_s")
            if self.mesh is not None:
                check_serving_layout(self.mcfg, self.scfg, self.mesh,
                                     adapters, tenants=len(order))
            sizes = [0] * len(order)
            for h in handles:
                sizes[order[h]] += 1
            starts = np.cumsum([0] + sizes[:-1])
            groups = tuple((int(s), n) for s, n in zip(starts, sizes))

        can_pad = all(k == "attn" for k in self.mcfg.layer_kinds())
        pad = max_len - P if can_pad else 0
        prefill, decode = self._get_steps(batch=B, max_len=max_len,
                                          pad=bool(pad), groups=groups)
        tokens, logits = _decode_loop(
            prefill, decode, self.params, adapters, toks, prompt_len=P,
            gen_len=gen_len, pad=pad, temperature=temperature, seed=seed,
            collect_logits=return_logits, clock=clock,
            rows=None if self.mesh is None else _Rows(decode.layout))
        tokens = tokens[inv]
        if return_logits:
            return tokens, [step[inv] for step in logits]
        return tokens


# ---------------------------------------------------------------------------
# Continuous-batching server (slot-scheduled; see repro_torch.launch.engine).
# ---------------------------------------------------------------------------

class EngineServer:
    """Request-routed continuous serving over one persistent
    :class:`~repro_torch.launch.engine.DecodeEngine` (counterpart of the
    reference's ``EngineServer``).

    Where :class:`MultiTenantServer` serves one static batch at a time,
    ``EngineServer`` keeps a slot table of ``slots`` decode rows alive
    across calls: ``run(requests)`` queues the requests (any mix of prompt
    lengths and adapters) and drives the engine until they drain. Requests
    join the running batch through per-row prefill, retire one by one on
    EOS, token budget or ``max_len``, and the freed rows admit whatever
    waits. Per-slot adapter handles resolve through ``cache``, the same
    :class:`AdapterStateCache` LRU as the static server.

    The keywords are the engine's. ``device``: None is the card, which
    must be present (the mesh's device when a mesh is given); ``"cpu"``
    is the explicit CPU request; ``params`` must live there. ``mesh``:
    the engine runs across it (``DecodeEngine(mesh=)``): ``params`` are
    this rank's shards, ``cache`` is keyed for this mesh
    (``AdapterStateCache.for_serving(mcfg, scfg, mesh)``), every rank
    runs the same requests and returns the same results; the slots may
    hold several adapters at once, grouped statically or dynamically,
    and the engine may speculate.
    """

    def __init__(self, mcfg, scfg: StepConfig, params, *,
                 cache: AdapterStateCache, slots: int, max_len: int,
                 mesh=None, temperature: float = 0.0, seed: int = 0,
                 allow_miss: bool = True, speculative_k: int = 0,
                 fault_plan=None, spec_accept_floor: float = 0.0,
                 paged: bool = False, block_size: int | None = None,
                 n_blocks: int | None = None,
                 prefill_chunk: int | None = None,
                 dynamic_grouping: bool = False,
                 max_active_per_adapter: int | None = None,
                 trace=None, device=None):
        from repro_torch.launch.engine import DecodeEngine
        _check_cache_mesh(cache, mesh)
        self.cache = cache
        self.engine = DecodeEngine(
            mcfg, scfg, params, slots=slots, max_len=max_len,
            adapter_cache=cache, mesh=mesh, temperature=temperature,
            seed=seed, allow_miss=allow_miss, speculative_k=speculative_k,
            fault_plan=fault_plan, spec_accept_floor=spec_accept_floor,
            paged=paged, block_size=block_size, n_blocks=n_blocks,
            prefill_chunk=prefill_chunk, dynamic_grouping=dynamic_grouping,
            max_active_per_adapter=max_active_per_adapter, trace=trace,
            device=device)

    def run(self, requests: Sequence[Request], *, gen_len: int,
            eos_id: int | None = None, on_token=None,
            speculative_k: int | None = None, deadline_ticks=None,
            priority=0):
        """Serve ``requests`` to completion through the slot table; returns
        a list of :class:`~repro_torch.launch.engine.RequestResult` in
        request order (``result.tokens`` holds the generated tokens,
        possibly fewer than ``gen_len`` on EOS or ``max_len``;
        ``finish_reason == "error"`` with ``result.error`` set when a
        request's adapter failed to resolve at admission, while the other
        requests still serve). ``on_token(request_id, token)`` streams
        tokens as they are sampled. The engine (``self.engine``) persists
        across calls, so its counters accumulate; sampling streams are
        keyed by each request's index within THIS call, so a repeated call
        at ``temperature > 0`` reproduces its tokens.
        ``speculative_k``: the engine's draft window for this call and
        later ones (0 = plain decode; None keeps the current one).
        ``deadline_ticks`` / ``priority``: one scalar for every request,
        or one entry a request (see ``DecodeEngine.submit``).

        Submission is all-or-nothing: every request is checked before the
        first is queued, so a bad one fails the call with nothing left in
        the persistent queue."""
        if not requests:
            raise ValueError("empty request batch")

        def per_request(v, name):
            if v is None or isinstance(v, (int, np.integer)):
                return [v] * len(requests)
            v = list(v)
            if len(v) != len(requests):
                raise ValueError(f"{name} has {len(v)} entries for "
                                 f"{len(requests)} requests")
            return v

        deadlines = per_request(deadline_ticks, "deadline_ticks")
        priorities = per_request(priority, "priority")
        if speculative_k is not None:
            if speculative_k < 0:
                raise ValueError(f"speculative_k={speculative_k} < 0")
            self.engine.speculative_k = int(speculative_k)
        return _serve_on_engine(
            self.engine, [(r.prompt, r.adapter) for r in requests],
            gen_len=gen_len, eos_id=eos_id, on_token=on_token,
            priorities=priorities, deadlines=deadlines)


def _serve_on_engine(engine, requests, *, gen_len: int, eos_id=None,
                     on_token=None, priorities=None, deadlines=None):
    """Submit (prompt, adapter) pairs to ``engine`` all or nothing (every
    one checked before the first is queued, so a bad one fails the call
    without stranding others in a persistent engine), drive it until they
    drain, and return their results in request order. Sampling streams
    are keyed by each request's index in the call."""
    n = len(requests)
    priorities = priorities or [0] * n
    deadlines = deadlines or [None] * n
    checked = [engine.check_request(p, adapter=a, max_new_tokens=gen_len)
               for p, a in requests]
    rids = [engine.submit(p, adapter=h, max_new_tokens=gen_len,
                          eos_id=eos_id, key_id=i,
                          priority=int(priorities[i] or 0),
                          deadline_ticks=deadlines[i])
            for i, (p, h) in enumerate(checked)]
    results = {res.request_id: res for res in engine.run(on_token)}
    return [results[rid] for rid in rids]


def _dump_obs(trace, engine, args) -> None:
    """Write what the CLI was asked for: ``--trace-out`` (JSONL when the
    path ends in .jsonl, else a Chrome trace) and ``--metrics-out``
    (Prometheus text, with the trace's latency histograms)."""
    from repro_torch.obs import engine_metrics

    if args.trace_out:
        if args.trace_out.endswith(".jsonl"):
            trace.to_jsonl(args.trace_out)
            kind = "jsonl"
        else:
            trace.to_chrome_trace(args.trace_out)
            kind = "chrome-trace"
        print(f"  obs: {len(trace)} events ({trace.dropped} dropped) -> "
              f"{args.trace_out} ({kind})")
    if args.metrics_out:
        engine_metrics(engine, trace).to_prometheus(args.metrics_out)
        print(f"  obs: metrics snapshot -> {args.metrics_out} "
              f"(prometheus text)")


def build_state(mcfg, dcfg: DoRAConfig, seed: int, device):
    """Random params and DoRA-initialized adapters from ``seed``, drawn on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(gen, mcfg)
    adapters = init_adapters(gen, mcfg, params, dcfg)
    return params, adapters


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=16.0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fold-gsb", action="store_true",
                    help="fold g*s into B in the serving state")
    ap.add_argument("--no-adapter-cache", action="store_true",
                    help="skip the frozen-adapter precompute (recompute the "
                         "factored norm every step)")
    ap.add_argument("--tenants", type=int, default=1, metavar="N",
                    help="multi-tenant demo: N adapter sets, --batch "
                         "requests each, served in ONE batch through "
                         "MultiTenantServer")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching demo: 2x--batch MIXED-length "
                         "requests of one registered tenant through "
                         "EngineServer (--batch slots; requests join and "
                         "leave mid-decode)")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="with --continuous: draft K base-model tokens a "
                         "tick and verify them in one adapted window; the "
                         "greedy streams are compared with a plain "
                         "engine's (asserted equal in fp32, counted in "
                         "bf16)")
    ap.add_argument("--inject", default="", metavar="SPEC",
                    help="with --continuous: a fault plan, e.g. 'nan@3' or "
                         "'nan@3:1,evict@5,stale@2,slow@4' (see "
                         "repro_torch.launch.faults.FaultPlan.parse); "
                         "asserts every request finishes once with a known "
                         "reason and the slot table drains")
    ap.add_argument("--deadline", type=int, default=0, metavar="N",
                    help="with --continuous: every request expires N engine "
                         "ticks after submission (finish_reason "
                         "'timeout')")
    ap.add_argument("--priority", type=int, default=0, metavar="N",
                    help="with --continuous: submit the LAST request at "
                         "priority N, so it admits ahead of the queue")
    ap.add_argument("--paged", action="store_true",
                    help="with --continuous: block-paged K/V cache and "
                         "chunked prefill; asserts the block pool drains "
                         "and compares the greedy streams with a "
                         "rectangular engine's (asserted equal in fp32, "
                         "counted in bf16)")
    ap.add_argument("--block-size", type=int, default=0, metavar="B",
                    help="with --paged: K/V block size (0 = auto: the "
                         "largest divisor of max_len up to 16)")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="fleet demo: N tenants over --batch slots through "
                         "the traced dynamic-grouping engine (one decode "
                         "signature), then the static one; the greedy "
                         "streams are compared (asserted equal in fp32, "
                         "counted in bf16)")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="with --continuous/--fleet: record the request "
                         "lifecycle and write it here, JSONL when PATH ends "
                         "in .jsonl, else a Chrome trace")
    ap.add_argument("--metrics-out", default="", metavar="PATH",
                    help="with --continuous/--fleet: write the engine's "
                         "metrics here as Prometheus text")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mcfg = get_config(args.arch, smoke=args.smoke)
    dcfg = DoRAConfig(rank=args.rank, alpha=args.alpha, mode="auto")
    scfg = StepConfig(dora=dcfg)
    params, adapters = build_state(mcfg, dcfg, args.seed, dev)
    rng = np.random.default_rng(args.seed)
    where = (probes.device_name(dev.index or 0) if dev.type == "cuda"
             else "cpu")
    if args.fleet > 1:
        _serve_fleet(args, mcfg, scfg, params, rng, dev, where)
        return
    if args.continuous:
        _serve_engine(args, mcfg, scfg, params, rng, dev, where)
        return
    if args.tenants > 1:
        _serve_tenants(args, mcfg, scfg, params, rng, dev, where)
        return
    prompts = rng.integers(0, mcfg.vocab_size, (args.batch, args.prompt_len))
    stats: dict = {}
    toks = generate(mcfg, params, adapters, scfg, prompts,
                    gen_len=args.gen_len,
                    max_len=args.prompt_len + args.gen_len,
                    temperature=args.temperature, seed=args.seed,
                    cache_adapters=not args.no_adapter_cache,
                    fold_gsb=args.fold_gsb, device=dev, stats=stats)
    toks = toks.cpu().numpy()
    print(f"generated [{toks.shape[0]}, {toks.shape[1]}] on {where}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stats.items())
          + f"; decode {args.batch * args.gen_len / stats['decode_s']:.1f}"
          f" tok/s")
    for b in range(min(args.batch, 2)):
        print(f"  seq{b}: ...{toks[b, args.prompt_len - 4:].tolist()}")


def _tenant_cache(args, mcfg, scfg, params, dev, tenants: int,
                  first_seed: int) -> AdapterStateCache:
    """A serving cache with ``tenants`` adapter sets registered as
    tenant-0, tenant-1, ..., each a fresh DoRA init from its own seed."""
    cache = AdapterStateCache.for_serving(mcfg, scfg, device=dev)
    for t in range(tenants):
        gen = torch.Generator(device=dev).manual_seed(first_seed + t)
        cache.register(f"tenant-{t}",
                       init_adapters(gen, mcfg, params, scfg.dora))
    return cache


def _mixed_requests(args, mcfg, rng, n_req: int, tenant) -> list:
    """``n_req`` requests with prompt lengths drawn from [prompt_len // 2,
    prompt_len]; ``tenant()`` names each one's adapter."""
    return [Request(rng.integers(
        0, mcfg.vocab_size,
        int(rng.integers(args.prompt_len // 2, args.prompt_len + 1)),
        dtype=np.int32), tenant()) for _ in range(n_req)]


def _timed_run(server: EngineServer, requests, **kw):
    """(results, wall seconds) of ``server.run``, ended by a device
    synchronisation."""
    t0 = time.perf_counter()
    results = server.run(requests, **kw)
    if server.engine.device.type == "cuda":
        torch.cuda.synchronize(server.engine.device)
    return results, time.perf_counter() - t0


def _streams_oracle(label: str, results, base, mcfg) -> None:
    """Compare the greedy streams of a run with its plain counterpart's:
    equal in fp32 (asserted); in bf16 the two round differently, so the
    number of equal streams is printed."""
    same = [r.tokens.tolist() == b.tokens.tolist()
            for r, b in zip(results, base)]
    if mcfg.dtype == torch.float32:
        for r, b, eq in zip(results, base, same):
            assert eq, (label, r.request_id, r.tokens, b.tokens)
        print(f"  {label}: greedy streams equal (oracle OK, fp32)")
    else:
        print(f"  {label}: {sum(same)} of {len(same)} streams equal "
              f"({mcfg.dtype}: not asserted)")


def _serve_fleet(args, mcfg, scfg, params, rng, dev, where) -> None:
    """``--fleet N``: ``max(2 x --batch, N)`` mixed-length requests over N
    tenants through the traced dynamic-grouping engine, then the same
    requests through a static-grouping engine as the oracle."""
    from repro_torch.obs import TraceRecorder

    cache = _tenant_cache(args, mcfg, scfg, params, dev, args.fleet,
                          args.seed + 1)
    n_req = max(2 * args.batch, args.fleet)
    requests = _mixed_requests(
        args, mcfg, rng, n_req,
        lambda: f"tenant-{int(rng.integers(args.fleet))}")
    max_len = args.prompt_len + args.gen_len
    trace = TraceRecorder() if args.trace_out or args.metrics_out else None
    dyn = EngineServer(mcfg, scfg, params, cache=cache, slots=args.batch,
                       max_len=max_len, temperature=args.temperature,
                       seed=args.seed, dynamic_grouping=True, trace=trace,
                       device=dev)
    results, dt = _timed_run(dyn, requests, gen_len=args.gen_len)
    st = dyn.engine.stats()
    sigs = dyn.engine.step_signatures()
    inserts = dyn.engine.device_steps()["adapter_insert"]
    # The port's counterpart of the reference's one dynamic decode
    # executable and one adapter-insert executable: every decode step ran
    # under the one signature, and every stack write was one insert.
    assert list(sigs["decode"]) == ["dynamic"], sigs
    assert 0 < inserts == st.stack_inserts, (inserts, st.stack_inserts)
    print(f"fleet: {n_req} requests x {args.fleet} tenants through "
          f"{args.batch} slots on {where} in {dt:.2f} s "
          f"({st.generated_tokens / dt:.1f} tok/s, {st.stack_inserts} "
          f"stack inserts, one dynamic decode signature)")
    cst = cache.stats()
    print(f"  cache: {cst.hits} hits / {cst.misses} misses / "
          f"{cst.current_bytes} state bytes")
    if trace is not None:
        _dump_obs(trace, dyn.engine, args)
    # The traced engine holds the cache's event hook: release it, so the
    # dynamic engine and its stack are freed before the static one runs.
    cache.on_event = None
    del dyn
    gc.collect()
    if args.temperature <= 0.0:
        static = EngineServer(mcfg, scfg, params, cache=cache,
                              slots=args.batch, max_len=max_len,
                              temperature=args.temperature, seed=args.seed,
                              device=dev)
        base, dt_s = _timed_run(static, requests, gen_len=args.gen_len)
        n_sigs = len(static.engine.step_signatures()["decode"])
        print(f"  static grouping: {dt_s:.2f} s "
              f"({static.engine.stats().generated_tokens / dt_s:.1f} "
              f"tok/s, {n_sigs} decode signatures)")
        _streams_oracle("fleet dynamic vs static", results, base, mcfg)
    for r in results[:2]:
        print(f"  req{r.request_id}: P={len(r.prompt)} "
              f"-> {r.tokens.tolist()} ({r.finish_reason})")


def _serve_engine(args, mcfg, scfg, params, rng, dev, where) -> None:
    """``--continuous``: 2 x ``--batch`` mixed-length requests of tenant-0
    through :class:`EngineServer`, with the fault-containment checks under
    ``--inject``/``--deadline``/``--priority`` and the paged and
    speculative oracles."""
    from repro_torch.launch.engine import FINISH_REASONS
    from repro_torch.launch.faults import FaultPlan
    from repro_torch.obs import TraceRecorder

    plan = FaultPlan.parse(args.inject) if args.inject else None
    faulty = plan is not None or args.deadline > 0 or args.priority > 0
    cache = _tenant_cache(args, mcfg, scfg, params, dev, 1, args.seed + 1)
    n_req = 2 * args.batch
    requests = _mixed_requests(args, mcfg, rng, n_req, lambda: "tenant-0")
    max_len = args.prompt_len + args.gen_len
    trace = TraceRecorder() if args.trace_out or args.metrics_out else None
    server = EngineServer(mcfg, scfg, params, cache=cache, slots=args.batch,
                          max_len=max_len, temperature=args.temperature,
                          seed=args.seed, speculative_k=args.speculative,
                          fault_plan=plan, paged=args.paged,
                          block_size=args.block_size or None, trace=trace,
                          device=dev)
    results, dt = _timed_run(
        server, requests, gen_len=args.gen_len,
        deadline_ticks=args.deadline if args.deadline > 0 else None,
        priority=([0] * (n_req - 1) + [args.priority]
                  if args.priority > 0 else 0))
    st = server.engine.stats()
    print(f"continuous: {n_req} mixed-length requests through {args.batch} "
          f"slots on {where} in {dt:.2f} s ({st.generated_tokens / dt:.1f} "
          f"tok/s, occupancy {st.mean_occupancy:.2f}, {st.decode_steps} "
          f"decode steps)")
    if faulty:
        # Fault containment: every request finishes once with a known
        # reason, and the slot table drains.
        hist: dict[str, int] = {}
        for r in results:
            hist[r.finish_reason] = hist.get(r.finish_reason, 0) + 1
        assert len(results) == n_req
        assert all(r.finish_reason in FINISH_REASONS for r in results)
        assert not server.engine.has_work(), "slot table did not drain"
        print(f"  faults: inject={args.inject or '-'} "
              f"deadline={args.deadline or '-'} "
              f"priority={args.priority or '-'} -> finish reasons "
              f"{sorted(hist.items())}")
        print(f"  counters: timeouts={st.timeouts} "
              f"quarantined={st.quarantined} preemptions={st.preemptions} "
              f"injected_nans={st.injected_nans} "
              f"forced_evictions={st.forced_evictions} "
              f"stale_injected={st.stale_injected} "
              f"slow_ticks={st.slow_ticks}")
    if args.paged:
        ps = server.engine.pool_stats()
        steps = server.engine.device_steps()
        assert ps["used_blocks"] == 0, f"leaked blocks: {ps}"
        assert ps["per_slot_blocks"] == [0] * args.batch, ps
        # Every admission went through the chunked prefill.
        assert steps["prefill_chunk"] > 0, steps
        assert steps["prefill_into_slot"] == 0, steps
        print(f"  paged: block_size={ps['block_size']} "
              f"n_blocks={ps['n_blocks']} chunk={ps['prefill_chunk']} "
              f"peak_used={ps['peak_used_blocks']} blocks (pool drained); "
              f"device steps {steps}")
    if args.speculative > 0:
        print(f"  speculative k={args.speculative}: {st.verify_steps} "
              f"verify + {st.draft_steps} draft steps, "
              f"{st.accepted_drafts} drafts accepted")
    if trace is not None:
        _dump_obs(trace, server.engine, args)
    # The oracle engine is rectangular and plain: it checks paging and
    # speculation at once.
    oracle = " ".join(w for w, on in (("paged", args.paged),
                                      ("speculative", args.speculative > 0))
                      if on)
    if oracle and args.temperature <= 0.0 and not faulty:
        del server
        plain = EngineServer(mcfg, scfg, params, cache=cache,
                             slots=args.batch, max_len=max_len,
                             temperature=args.temperature, seed=args.seed,
                             device=dev)
        base, dt_p = _timed_run(plain, requests, gen_len=args.gen_len)
        print(f"  plain rectangular engine: {dt_p:.2f} s "
              f"({plain.engine.stats().generated_tokens / dt_p:.1f} tok/s)")
        _streams_oracle(f"{oracle} vs plain rectangular", results, base,
                        mcfg)
    for r in results[:2]:
        print(f"  req{r.request_id}: P={len(r.prompt)} "
              f"-> {r.tokens.tolist()} ({r.finish_reason})")


def _serve_tenants(args, mcfg, scfg, params, rng, dev, where) -> None:
    """``--tenants N``: N adapter sets registered with one cache, ``--batch``
    requests each, served in one batch; prints the phases and the cache's
    counters."""
    cache = _tenant_cache(args, mcfg, scfg, params, dev, args.tenants,
                          args.seed + 1)
    requests = [Request(rng.integers(0, mcfg.vocab_size, args.prompt_len),
                        f"tenant-{t}")
                for t in range(args.tenants) for _ in range(args.batch)]
    server = MultiTenantServer(mcfg, scfg, params, cache=cache, device=dev)
    stats: dict = {}
    toks = server.serve(requests, gen_len=args.gen_len,
                        max_len=args.prompt_len + args.gen_len,
                        temperature=args.temperature, seed=args.seed,
                        stats=stats).cpu().numpy()
    st = cache.stats()
    print(f"served {len(requests)} requests x {args.tenants} tenants on "
          f"{where}: " + ", ".join(f"{k} {v:.3f}" for k, v in stats.items())
          + f"; decode {len(requests) * args.gen_len / stats['decode_s']:.1f}"
          f" tok/s; cache: {st.hits} hits / {st.misses} misses / "
          f"{st.current_bytes} state bytes")
    for b in range(min(len(requests), 2)):
        print(f"  req{b}: ...{toks[b, args.prompt_len - 4:].tolist()}")


if __name__ == "__main__":
    main()
