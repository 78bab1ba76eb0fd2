#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA H100.

Run from the repository root on a machine with the card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version at the shapes the
serving path gives it, then serves full-width qwen2-7b (28 layers, random
weights from a seed) with r=384 DoRA adapters on all seven projections
through ``repro_torch.launch.serve.generate``:

  1. auto mode in bf16 (the main path): precompute, padded prefill of
     4 x 1024, 32 decode tokens; the kernel launch counts must be
     K1 = K2 = 196, K6 = 140, K3 = 0;
  2. forced kernel mode (``mode="fused"``), a few decode tokens: K6 = 196
     per prefill and K3 = 196 per decode token;
  3. the paper's criterion, prefill logit cosine >= 0.9999, between the
     kernel route and an explicitly requested eager route, and between
     forced and auto mode, on the same weights upcast to fp32 (see
     serve_checks for why not in bf16); in bf16 the kernel route must be
     no further from the fp32 logits than the bf16 eager route;
  4. a 2-layer fp32 model served on the card and on the CPU (the kernels'
     plain versions), whose prefill logits must agree within
     1e-4 x max|logit| and whose greedy tokens must match.

Any failed check raises, so the exit code is non-zero. The line before
the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero before
printing anything.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}  # dense; fp32 on CUDA cores (no TF32)
F32_OPS = 67e12

ARCH, BATCH, PROMPT, GEN, MAX_LEN = "qwen2-7b", 4, 960, 32, 1024
RANK, ALPHA, SEED = 384, 192.0, 0
FORCED_GEN = 3
COSINE_MIN = 0.9999

SOURCES = {
    "norm_terms": ("src/repro_torch/kernels/csrc/norm_terms.cu",
                   "src/repro/kernels/factored_norm.py:49"),
    "assemble_norm": ("src/repro_torch/kernels/csrc/assemble_norm.cu",
                      "src/repro/kernels/norm_assembly.py:37"),
    "compose_fwd": ("src/repro_torch/kernels/csrc/compose.cu",
                    "src/repro/kernels/dora_compose.py:106"),
    "compose_mm_fwd": ("src/repro_torch/kernels/csrc/compose_mm.cu",
                       "src/repro/kernels/dora_compose.py:211"),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {msg}")


def time_ms(fn, *, target_ms: float = 150.0) -> float:
    """Mean device time of ``fn()`` in ms from CUDA events, after a warm-up,
    over enough launches to fill about ``target_ms``."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = int(min(50, max(3, target_ms / once)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops_s: float) -> tuple[float, str]:
    """Least time for the work: the larger of bytes over the memory rate
    and ``ops_s`` (operations already divided by their peak rates)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, ops_s) * 1e3,
            "bytes" if t_bytes >= ops_s else "operations")


def max_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max |want|) in fp32."""
    g, w = got.float(), want.float()
    return (g - w).abs().max().item(), w.abs().max().item()


def cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


# ---------------------------------------------------------------------------
# Kernel-by-kernel checks at the serving path's shapes.
# ---------------------------------------------------------------------------

def kernel_checks(dev) -> dict:
    from repro_torch.kernels import dora_compose as kc
    from repro_torch.kernels import factored_norm as kn
    from repro_torch.kernels import norm_assembly as ka

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bf = torch.bfloat16
    esz = 2
    s = ALPHA / math.sqrt(RANK)

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype)

    rows = {"norm_terms": [], "assemble_norm": [], "compose_fwd": [],
            "compose_mm_fwd": []}

    def record(name, shape, err, ref_max, rel, ms, plain, nbytes, ops_s,
               lib_ms=None, lib_call=None, **extra):
        tol = rel * ref_max
        b_ms, b_by = bound_ms(nbytes, ops_s)
        row = {"shape": shape, "max_abs_err": err, "tol": tol,
               "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": lib_ms,
               "library_call": lib_call, **extra}
        rows[name].append(row)
        print(f"  {name} {shape}: err {err:.3g} (tol {tol:.3g}), "
              f"{ms:.4f} ms vs plain {plain:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by})" + (f", {lib_call} {lib_ms:.4f} ms"
                             if lib_ms is not None else ""), flush=True)
        check(err <= tol, f"{name} {shape}: max err {err} > tol {tol}")

    # K1 and K2 on the wq, wk, w_gate and w_down weight shapes.
    for d_out, d_in in ((3584, 3584), (512, 3584), (18944, 3584),
                        (3584, 18944)):
        W = randn(d_out, d_in, scale=d_in ** -0.5)
        A = ((torch.rand((RANK, d_in), generator=gen, device=dev) * 2 - 1)
             * d_in ** -0.5).to(bf)
        B = randn(d_out, RANK, scale=0.02)
        base, cross = kn.norm_terms(W, A, B)
        pb, pc = kn.norm_terms_plain(W, A, B)
        e1, m1 = max_err(base, pb)
        e2, m2 = max_err(cross, pc)
        # Both terms are fp32 sums of d_in (x r) products taken in another
        # order than the plain matmul: 1e-4 of the largest magnitude of
        # the output (base_sq and cross together).
        nbytes = (d_out * d_in + RANK * d_in + d_out * RANK) * esz \
            + 2 * d_out * 4
        ops_s = (2 * d_out * d_in * RANK) / PEAK_OPS[bf] \
            + (2 * d_out * d_in + 2 * d_out * RANK) / F32_OPS
        record("norm_terms", [d_out, d_in, RANK], max(e1, e2), max(m1, m2),
               1e-4, time_ms(lambda: kn.norm_terms(W, A, B)),
               time_ms(lambda: kn.norm_terms_plain(W, A, B)), nbytes, ops_s,
               time_ms(lambda: W @ A.T), "W @ A.T",
               base_sq_rel_err=e1 / m1, cross_rel_err=e2 / m2)
        A32, B32 = A.float(), B.float()
        ba = ((B32 @ (A32 @ A32.T)) * B32).sum(dim=1)
        out = ka.assemble_norm(pb, pc, ba, s)
        ref = ka.assemble_norm_plain(pb, pc, ba, s)
        e, mx = max_err(out, ref)
        # Same pinned fp32 operations on both sides: within 1e-6.
        record("assemble_norm", [d_out], e, mx, 1e-6,
               time_ms(lambda: ka.assemble_norm(pb, pc, ba, s)),
               time_ms(lambda: ka.assemble_norm_plain(pb, pc, ba, s)),
               4 * d_out * 4, 5 * d_out / F32_OPS,
               bitwise_equal_plain=bool(torch.equal(out, ref)))
        del W, A, B

    # K3 at decode (M = 4) and prefill-sized rows.
    for m, n in ((4, 3584), (4, 18944), (4096, 18944)):
        base = randn(m, n)
        lora = randn(m, n, scale=2.0)
        gm1 = randn(n, scale=0.05, dtype=torch.float32)
        out = kc.compose_fwd(base, lora, gm1, s)
        ref = kc.compose_fwd_plain(base, lora, gm1, s)
        e, mx = max_err(out, ref)
        # Same pinned fp32 operations, one bf16 rounding: one bf16 ulp of
        # the largest value.
        record("compose_fwd", [m, n], e, mx, 2.0 ** -8,
               time_ms(lambda: kc.compose_fwd(base, lora, gm1, s)),
               time_ms(lambda: kc.compose_fwd_plain(base, lora, gm1, s)),
               3 * m * n * esz + n * 4, 5 * m * n / F32_OPS,
               bitwise_equal_plain=bool(torch.equal(out, ref)))
        del base, lora

    # K6 at prefill rows on the d_out of wq/wo/w_down and of w_gate/w_up.
    for m, n in ((4096, 3584), (4096, 18944)):
        base = randn(m, n)
        h = randn(m, RANK, scale=0.5)
        B = randn(n, RANK, scale=0.02)
        gm1 = randn(n, scale=0.05, dtype=torch.float32)
        out = kc.compose_mm_fwd(base, h, B, gm1, s)
        ref = kc.compose_mm_fwd_plain(base, h, B, gm1, s)
        e, mx = max_err(out, ref)
        # lora is an fp32 sum in another order than cuBLAS's, then one
        # bf16 rounding: two bf16 ulps of the largest value.
        record("compose_mm_fwd", [m, n, RANK], e, mx, 2.0 ** -7,
               time_ms(lambda: kc.compose_mm_fwd(base, h, B, gm1, s)),
               time_ms(lambda: kc.compose_mm_fwd_plain(base, h, B, gm1, s)),
               2 * m * n * esz + (m + n) * RANK * esz + n * 4,
               2 * m * n * RANK / PEAK_OPS[bf] + 5 * m * n / F32_OPS,
               time_ms(lambda: h @ B.T), "h @ B.T")
        del base, h, B
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Serving at full width.
# ---------------------------------------------------------------------------

def perturb_adapters(adapters, gen):
    """Nonzero B (normal x 0.02) and m = ||W||·(1 + 0.01·noise), so that
    g != 1 and the lora term is not zero."""
    for leaf in _adapter_leaves(adapters):
        B, m = leaf["B"], leaf["m"]
        leaf["B"] = (torch.randn(B.shape, generator=gen, device=B.device)
                     * 0.02).to(B.dtype)
        leaf["m"] = m * (1.0 + 0.01 * torch.randn(
            m.shape, generator=gen, device=m.device))
    return adapters


def _adapter_leaves(tree):
    if isinstance(tree, dict) and {"A", "B", "m"} <= set(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _adapter_leaves(v)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def serve_checks(dev) -> dict:
    """The main path (bf16, auto mode), then forced kernel mode, then the
    same weights upcast to fp32 for the logit-cosine criterion.

    Why fp32 for the criterion: with random weights every bf16 route sits
    about 1e-4 of cosine away from the exact logits (the rounding of some
    hundred bf16 activations per layer stack decorrelates once two routes
    differ by one ulp anywhere), so two bf16 routes cannot be held to
    cosine >= 0.9999 of each other. In fp32 the kernel route and the eager
    route must agree; in bf16 the kernel route must be no further from the
    fp32 eager logits than the bf16 eager route is (within 2x)."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch import serve
    from repro_torch.launch.steps import StepConfig

    mcfg = get_config(ARCH)
    cfg = {mode: StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA,
                                            mode=mode))
           for mode in ("auto", "fused", "eager")}
    t0 = time.perf_counter()
    params, adapters = serve.build_state(mcfg, cfg["auto"].dora, SEED, dev)
    adapters = perturb_adapters(
        adapters, torch.Generator(device=dev).manual_seed(SEED + 1))
    torch.cuda.synchronize()
    print(f"serve: built {ARCH} ({mcfg.num_layers} layers, d_model "
          f"{mcfg.d_model}, d_ff {mcfg.d_ff}, vocab {mcfg.vocab_size}, "
          f"{mcfg.dtype}) with r={RANK} DoRA on 7 targets in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prompts = np.random.default_rng(SEED).integers(
        0, mcfg.vocab_size, (BATCH, PROMPT))

    def prefill_logits(m, p, a, mode):
        _, lg = serve.generate(m, p, a, cfg[mode], prompts, gen_len=1,
                               max_len=MAX_LEN, device=dev,
                               return_logits=True)
        return lg[0].float()

    # Warm the path once (cuBLAS handles, allocator) outside the counts.
    prefill_logits(mcfg, params, adapters, "auto")

    # --- the main path: auto mode, bf16 ---
    torch.cuda.reset_peak_memory_stats(dev)
    stats: dict = {}
    kernels.reset_launch_counts()
    toks, logits = serve.generate(
        mcfg, params, adapters, cfg["auto"], prompts, gen_len=GEN,
        max_len=MAX_LEN, device=dev, return_logits=True, stats=stats)
    torch.cuda.synchronize()
    auto_counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_adapted = 7 * mcfg.num_layers
    check(auto_counts == {"norm_terms": n_adapted,
                          "assemble_norm": n_adapted, "compose_fwd": 0,
                          "compose_mm_fwd": 5 * mcfg.num_layers},
          f"auto-mode launch counts {auto_counts}")
    check(tuple(toks.shape) == (BATCH, PROMPT + GEN), f"tokens {toks.shape}")
    check(all(torch.isfinite(lg.float()).all().item() for lg in logits),
          "non-finite logits in the auto run")
    check(((toks >= 0) & (toks < mcfg.vocab_size)).all().item(),
          "token ids out of range")
    serve_auto = {
        "precompute_ms": stats["precompute_s"] * 1e3,
        "prefill_ms": stats["prefill_s"] * 1e3,
        "decode_ms_per_token": stats["decode_s"] * 1e3 / GEN,
        "decode_tok_per_s": BATCH * GEN / stats["decode_s"],
        "max_memory_allocated_bytes": peak, "launches": auto_counts}
    print("serve auto (bf16): " + json.dumps(serve_auto), flush=True)

    # --- forced kernel mode, bf16: K6 at every prefill projection, K3 at
    # every decode projection ---
    kernels.reset_launch_counts()
    fstats: dict = {}
    _, flogits = serve.generate(
        mcfg, params, adapters, cfg["fused"], prompts, gen_len=FORCED_GEN,
        max_len=MAX_LEN, device=dev, return_logits=True, stats=fstats)
    torch.cuda.synchronize()
    fused_counts = kernels.launch_counts()
    check(fused_counts == {"norm_terms": n_adapted,
                           "assemble_norm": n_adapted,
                           "compose_fwd": n_adapted * FORCED_GEN,
                           "compose_mm_fwd": n_adapted},
          f"forced-mode launch counts {fused_counts}")
    serve_fused = {"prefill_ms": fstats["prefill_s"] * 1e3,
                   "decode_ms_per_token":
                       fstats["decode_s"] * 1e3 / FORCED_GEN,
                   "launches": fused_counts}

    # --- eager route, bf16: no kernel may launch ---
    kernels.reset_launch_counts()
    eager_bf16 = prefill_logits(mcfg, params, adapters, "eager")
    check(sum(kernels.launch_counts().values()) == 0,
          "the eager route launched a kernel")

    # --- the same weights in fp32: the paper's cosine criterion ---
    mcfg32 = dataclasses.replace(mcfg, dtype=torch.float32)
    p32 = _tree_map(lambda t: t.float(), params)
    a32 = _tree_map(lambda t: t.float(), adapters)
    kernels.reset_launch_counts()
    auto32 = prefill_logits(mcfg32, p32, a32, "auto")
    check(kernels.launch_counts()["compose_mm_fwd"] == 5 * mcfg.num_layers,
          "fp32 auto run did not take the matmul-fused kernel")
    fused32 = prefill_logits(mcfg32, p32, a32, "fused")
    eager32 = prefill_logits(mcfg32, p32, a32, "eager")
    del p32, a32
    cos = {
        "fp32_auto_vs_eager": cosine(auto32, eager32),
        "fp32_fused_vs_auto": cosine(fused32, auto32),
        "bf16_auto_vs_bf16_eager": cosine(logits[0], eager_bf16),
        "bf16_fused_vs_bf16_auto": cosine(flogits[0], logits[0]),
        "bf16_auto_vs_fp32_eager": cosine(logits[0], eager32),
        "bf16_eager_vs_fp32_eager": cosine(eager_bf16, eager32),
    }
    print("serve fused (bf16): " + json.dumps(serve_fused), flush=True)
    print("prefill logit cosines: " + json.dumps(cos), flush=True)
    check(cos["fp32_auto_vs_eager"] >= COSINE_MIN,
          f"fp32 kernel route vs eager route cosine "
          f"{cos['fp32_auto_vs_eager']}")
    check(cos["fp32_fused_vs_auto"] >= COSINE_MIN,
          f"fp32 forced vs auto cosine {cos['fp32_fused_vs_auto']}")
    check(1 - cos["bf16_auto_vs_fp32_eager"]
          <= 2 * (1 - cos["bf16_eager_vs_fp32_eager"]) + 1e-9,
          "bf16 kernel route is further from the fp32 logits than the bf16 "
          "eager route")
    del params, adapters
    torch.cuda.empty_cache()
    return {"auto": auto_counts, "fused": fused_counts,
            "serve_auto": serve_auto, "serve_fused": serve_fused,
            "cosines": cos}


def small_parity(dev) -> None:
    """A 2-layer fp32 model on the card (kernels) and on the CPU (their
    plain versions), from the same weights."""
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch import serve
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models.config import ModelConfig

    mcfg = ModelConfig(name="parity-2l", family="dense", num_layers=2,
                       d_model=256, num_heads=2, num_kv_heads=1, d_ff=512,
                       vocab_size=512, qkv_bias=True, attn_chunk=16,
                       dtype=torch.float32)
    scfg = StepConfig(dora=DoRAConfig(rank=16, alpha=32.0, mode="fused"))
    params, adapters = serve.build_state(mcfg, scfg.dora, SEED, "cpu")
    adapters = perturb_adapters(adapters,
                                torch.Generator().manual_seed(SEED + 1))
    on_dev = lambda t: ({k: on_dev(v) for k, v in t.items()}
                        if isinstance(t, dict) else t.to(dev))
    prompts = np.random.default_rng(SEED).integers(0, 512, (2, 20))
    out = {}
    for where, p, a in (("cpu", params, adapters),
                        ("cuda", on_dev(params), on_dev(adapters))):
        out[where] = serve.generate(mcfg, p, a, scfg, prompts, gen_len=6,
                                    max_len=32, device=where,
                                    return_logits=True)
    (t_cpu, l_cpu), (t_dev, l_dev) = out["cpu"], out["cuda"]
    err, mx = max_err(l_dev[0].cpu(), l_cpu[0])
    print(f"small parity (2 layers, fp32, card vs CPU plain): prefill logit "
          f"err {err:.3g} (tol {1e-4 * mx:.3g}), tokens equal "
          f"{torch.equal(t_dev.cpu(), t_cpu)}", flush=True)
    check(err <= 1e-4 * mx, f"small parity logits err {err}")
    check(torch.equal(t_dev.cpu(), t_cpu), "small parity greedy tokens")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch import probes
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"device: {probes.report()}", flush=True)
    probes.require_cuda(0)
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{lib.relative_to(root)}", flush=True)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")

    print("kernels vs plain versions:", flush=True)
    rows = kernel_checks(dev)
    small_parity(dev)
    served = serve_checks(dev)

    # The shape each kernel's top-level numbers are read at: w_gate for
    # the norm pair, the forced-mode decode rows on w_gate for K3, the
    # prefill rows on w_gate for K6.
    headline = {"norm_terms": 2, "assemble_norm": 2, "compose_fwd": 1,
                "compose_mm_fwd": 1}
    record = []
    for name, (src, replaces) in SOURCES.items():
        top = rows[name][headline[name]]
        path = "serve_fused" if name == "compose_fwd" else "serve_auto"
        counts = served["fused" if path == "serve_fused" else "auto"]
        check(counts[name] > 0, f"{name} never launched on {path}")
        record.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[name], "path": path,
            "launches_by_path": {"serve_auto": served["auto"][name],
                                 "serve_fused": served["fused"][name]},
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "tol": top["tol"], "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "library_call": top["library_call"], "at_shape": top["shape"],
            "shapes": rows[name]})
    print(json.dumps({"kernels": record, "card": smi,
                      "serve": {k: served[k] for k in
                                ("serve_auto", "serve_fused", "cosines")}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
