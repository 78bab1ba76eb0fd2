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

``--arch`` takes every arch of ``repro_torch.configs``: qwen2-7b,
falcon-mamba-7b, phi4-mini-3.8b, qwen2-vl-7b, chatglm3-6b, qwen3-32b,
musicgen-medium and qwen2-vl-72b. The prompts are token ids, for the
frontend archs too (their frontends are stubs; precomputed embeddings go
through ``launch/steps.py``'s prefill and decode steps).

``--continuous`` serves 2 x ``--batch`` mixed-length requests through the
continuous-batching engine (``--batch`` slots; ``launch/engine.py``),
``--paged`` with its block-paged K/V cache and chunked prefill.

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
from repro_torch.launch.steps import (PhaseClock, StepConfig,
                                      make_decode_step, make_precompute_step,
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
    """The cache keys states on the layout they were placed for; serving
    them under another would re-lay them out every step. The port serves
    on one card, so a mesh is refused (``mesh_fingerprint``) and a cache
    keyed for any other layout than ``None`` is refused here."""
    want = mesh_fingerprint(mesh)
    if cache.sharding != want:
        raise ValueError(
            f"adapter cache is keyed for sharding {cache.sharding} but "
            f"serving runs on layout {want} (one card) — build the cache "
            f"with AdapterStateCache.for_serving(mcfg, scfg) so its states "
            f"are placed for this layout")


def _sample(last, temperature: float, generator):
    if temperature > 0.0:
        probs = torch.softmax(last.float() / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
    else:
        nxt = torch.argmax(last, dim=-1)
    return nxt[:, None]


def _decode_loop(prefill, decode, params, adapters, toks, *, prompt_len,
                 gen_len, pad, temperature, seed, collect_logits=False,
                 clock: PhaseClock | None = None):
    """The prefill → sample → decode loop. Returns (tokens [B, P+gen_len],
    the logits each sampled token was drawn from, or None)."""
    clock = clock or PhaseClock(None, toks.device)
    P = prompt_len
    batch_in = {"tokens": toks}
    if pad:
        batch_in = {"tokens": torch.nn.functional.pad(toks, (0, pad)),
                    "prompt_len": P}
    clock.start()
    logits, cache = prefill(params, adapters, batch_in)
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
        last, cache = decode(params, adapters, cache, {"tokens": nxt})
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

    ``device``: None is the card, which must be present; ``"cpu"`` is the
    explicit CPU request. ``params``/``adapters`` must already live there.
    ``cache_adapters``: precompute the frozen-adapter state (cached g)
    before prefill (a handle's state comes from the cache instead).
    ``fold_gsb``: also fold g·s into B. ``mesh``: refused, the port serves
    on one card.
    ``stats``: when given, filled with the wall seconds of each phase
    (``precompute_s``: the precompute, or the cache lookup of a handle;
    ``prefill_s``, ``decode_s``), each ended by a device synchronisation.
    """
    dev = resolve_device(device)
    if params["embed"].device != dev:
        raise ValueError(f"params live on {params['embed'].device}, serving "
                         f"was asked on {dev}")
    mesh_fingerprint(mesh)           # refuses a mesh: one card
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
        adapters = make_precompute_step(mcfg, scfg, fold_gsb=fold_gsb)(
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
    prefill = make_prefill_step(mcfg, scfg, batch=B, seq=max_len,
                                padded=bool(pad))
    decode = make_decode_step(mcfg, scfg, batch=B)
    tokens, logits = _decode_loop(
        prefill, decode, params, adapters, toks, prompt_len=P,
        gen_len=gen_len, pad=pad, temperature=temperature, seed=seed,
        collect_logits=return_logits, clock=clock)
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

    ``device``: None is the card, which must be present; ``"cpu"`` is the
    explicit CPU request; ``params`` must live there. ``mesh`` is
    refused: the port serves on one card.
    """

    def __init__(self, mcfg, scfg: StepConfig, params, *,
                 cache: AdapterStateCache, mesh=None,
                 max_cached_steps: int = 32, engine_slots: int = 8,
                 dynamic_grouping: bool = False,
                 max_active_per_adapter: int | None = None,
                 trace=None, device=None):
        _check_cache_mesh(cache, mesh)
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"serving was asked on {self.device}")
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
        prefill = make_prefill_step(self.mcfg, self.scfg, batch=batch,
                                    seq=max_len, padded=pad,
                                    tenant_groups=groups)
        decode = make_decode_step(self.mcfg, self.scfg, batch=batch,
                                  tenant_groups=groups)
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
                               adapter_cache=self.cache,
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
        checked = [eng.check_request(p, adapter=self._resolve(r),
                                     max_new_tokens=gen_len)
                   for r, p in zip(requests, prompts)]
        rids = [eng.submit(p, adapter=h, max_new_tokens=gen_len, key_id=i)
                for i, (p, h) in enumerate(checked)]
        results = {res.request_id: res for res in eng.run()}
        for rid in rids:
            if results[rid].finish_reason == "error":
                # A late resolution failed at admission: the engine has
                # already dropped the request, so it is not wedged.
                raise results[rid].error
        return [np.concatenate([p, results[rid].tokens])
                for p, rid in zip(prompts, rids)]

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
            collect_logits=return_logits, clock=clock)
        tokens = tokens[inv]
        if return_logits:
            return tokens, [step[inv] for step in logits]
        return tokens


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
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching demo: 2x--batch MIXED-length "
                         "requests through the slot-scheduled engine "
                         "(--batch slots; requests join/leave mid-decode)")
    ap.add_argument("--paged", action="store_true",
                    help="with --continuous: block-paged K/V cache + "
                         "chunked prefill; asserts the block pool drains")
    ap.add_argument("--block-size", type=int, default=0, metavar="B",
                    help="with --paged: K/V block size (0 = auto: the "
                         "largest divisor of max_len up to 16)")
    ap.add_argument("--tenants", type=int, default=1, metavar="N",
                    help="multi-tenant demo: N adapter sets, --batch "
                         "requests each, served in ONE batch through "
                         "MultiTenantServer")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    for flag in ("--speculative", "--inject", "--deadline"):
        ap.add_argument(flag, default=None, help="not ported yet: comes "
                        "with the cache-routed EngineServer CLI (ROADMAP "
                        "queue 1 item 4.5)")
    args = ap.parse_args(argv)
    for flag in ("speculative", "inject", "deadline"):
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"serve --{flag} is not ported yet: it comes with the "
                f"cache-routed EngineServer CLI (ROADMAP queue 1 item 4.5)")

    dev = resolve_device(args.device)
    mcfg = get_config(args.arch, smoke=args.smoke)
    dcfg = DoRAConfig(rank=args.rank, alpha=args.alpha, mode="auto")
    scfg = StepConfig(dora=dcfg)
    params, adapters = build_state(mcfg, dcfg, args.seed, dev)
    rng = np.random.default_rng(args.seed)
    where = (probes.device_name(dev.index or 0) if dev.type == "cuda"
             else "cpu")
    if args.continuous:
        _serve_continuous(args, mcfg, scfg, params, adapters, rng, dev,
                          where)
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


def _serve_tenants(args, mcfg, scfg, params, rng, dev, where) -> None:
    """``--tenants N``: N adapter sets registered with one cache, ``--batch``
    requests each, served in one batch; prints the phases and the cache's
    counters."""
    cache = AdapterStateCache.for_serving(mcfg, scfg, device=dev)
    requests = []
    for t in range(args.tenants):
        gen = torch.Generator(device=dev).manual_seed(args.seed + 1 + t)
        cache.register(f"tenant-{t}",
                       init_adapters(gen, mcfg, params, scfg.dora))
        for _ in range(args.batch):
            requests.append(Request(rng.integers(0, mcfg.vocab_size,
                                                 args.prompt_len),
                                    f"tenant-{t}"))
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


def _serve_continuous(args, mcfg, scfg, params, adapters, rng, dev,
                      where) -> None:
    """The single-tenant engine over 2 x ``--batch`` requests with prompt
    lengths drawn from [prompt_len // 2, prompt_len]."""
    import time

    from repro_torch.launch.engine import DecodeEngine

    state = make_precompute_step(mcfg, scfg, fold_gsb=True)(params,
                                                            adapters)
    engine = DecodeEngine(mcfg, scfg, params, slots=args.batch,
                          max_len=args.prompt_len + args.gen_len,
                          adapters=state, temperature=args.temperature,
                          seed=args.seed, paged=args.paged,
                          block_size=((args.block_size or None)
                                      if args.paged else None),
                          device=dev)
    n_req = 2 * args.batch
    for i in range(n_req):
        p_len = int(rng.integers(args.prompt_len // 2, args.prompt_len + 1))
        engine.submit(rng.integers(0, mcfg.vocab_size, p_len),
                      max_new_tokens=args.gen_len, key_id=i)
    t0 = time.perf_counter()
    results = engine.run()
    dt = time.perf_counter() - t0
    st = engine.stats()
    print(f"continuous: {n_req} mixed-length requests through {args.batch} "
          f"slots on {where} in {dt:.2f}s ({st.generated_tokens / dt:.1f} "
          f"tok/s, occupancy {st.mean_occupancy:.2f}, {st.decode_steps} "
          f"decode steps)")
    if args.paged:
        ps = engine.pool_stats()
        assert ps["used_blocks"] == 0, f"leaked blocks: {ps}"
        assert ps["per_slot_blocks"] == [0] * args.batch, ps
        print(f"  paged: block_size={ps['block_size']} "
              f"n_blocks={ps['n_blocks']} chunk={ps['prefill_chunk']} "
              f"peak_used={ps['peak_used_blocks']} blocks (pool drained); "
              f"device steps {engine.device_steps()}")
    for r in results[:2]:
        print(f"  req{r.request_id}: P={len(r.prompt)} "
              f"-> {r.tokens.tolist()} ({r.finish_reason})")


if __name__ == "__main__":
    main()
