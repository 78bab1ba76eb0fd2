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

``--arch`` takes every arch of ``repro_torch.configs``: qwen2-7b,
falcon-mamba-7b, phi4-mini-3.8b, qwen2-vl-7b, chatglm3-6b, qwen3-32b,
musicgen-medium and qwen2-vl-72b. The prompts are token ids, for the
frontend archs too (their frontends are stubs; precomputed embeddings go
through ``launch/steps.py``'s prefill and decode steps).

``--continuous`` serves 2 x ``--batch`` mixed-length requests through the
continuous-batching engine (``--batch`` slots; ``launch/engine.py``),
``--paged`` with its block-paged K/V cache and chunked prefill.

Weights are random, drawn from ``--seed`` on the serving device.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import probes
from repro_torch.configs import get_config
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
             fold_gsb: bool = False, return_logits: bool = False,
             device=None, stats: dict | None = None):
    """prompts: int [B, P] (numpy or tensor). Returns tokens [B, P+gen_len]
    (int64, on ``device``), or (tokens, per-step logits) with
    ``return_logits``.

    ``device``: None is the card, which must be present; ``"cpu"`` is the
    explicit CPU request. ``params``/``adapters`` must already live there.
    ``cache_adapters``: precompute the frozen-adapter state (cached g)
    before prefill. ``fold_gsb``: also fold g·s into B.
    ``stats``: when given, filled with the wall seconds of each phase
    (``precompute_s``, ``prefill_s``, ``decode_s``), each ended by a
    device synchronisation.
    """
    dev = resolve_device(device)
    if params["embed"].device != dev:
        raise ValueError(f"params live on {params['embed'].device}, serving "
                         f"was asked on {dev}")
    clock = PhaseClock(stats, dev)
    if cache_adapters:
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


def build_state(mcfg, dcfg: DoRAConfig, seed: int, device):
    """Random params and DoRA-initialized adapters from ``seed``, drawn on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(gen, mcfg)
    adapters = init_adapters(gen, mcfg, params, dcfg)
    return params, adapters


def main() -> None:
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
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args()

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
