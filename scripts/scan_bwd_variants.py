#!/usr/bin/env python3
"""Where the time of the scan's backward kernel goes, on the card.

Run from the repository root on a machine with the card:

    python3 scripts/scan_bwd_variants.py [--out FILE]

Each variant is a copy of ``src/repro_torch/kernels/csrc`` with
``selective_scan_bwd.cu`` patched (the patches below: one part of the
design taken out, or done another way), compiled apart by ``nvcc`` into
``build/scan_bwd_variants/<name>/`` and loaded beside the port's own
library. All run at the falcon-mamba-7b training shape [2, 2048, 8192],
n = 16, on the same inputs, in turns (the unpatched kernel first and
last): ms by CUDA events (three windows), the main and the partial-sum
kernels' device time from the profiler, registers from ptxas, and the
largest error against the unpatched kernel relative to its largest
|grad| (variants that leave a part out give wrong gradients: they are
timings only). Prints one line a variant and writes the rows as JSON to
``--out`` (default ``build/scan_bwd_variants.json``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import selective_scan as ks  # noqa: E402

OUT_DIR = ROOT / "build" / "scan_bwd_variants"

# The d_B/d_C channel sum with a select before every shuffle, states in
# slot order g*kS + j (no lane-XOR slots).
SELECTS = [("const int x = (lane / L) % kS;", "const int x = 0;"),
           ('''#pragma unroll
  for (int m = L, k = 32 / L; m < 16; m <<= 1, k >>= 1) {
#pragma unroll
    for (int j = 0; j < k / 2; ++j)
      v[j] = v[2 * j] + __shfl_xor_sync(0xffffffffu, v[2 * j + 1], m);
  }
  const bool up = lane & 16;
  return (up ? v[1] : v[0]) +
         __shfl_xor_sync(0xffffffffu, up ? v[0] : v[1], 16);''',
            '''#pragma unroll
  for (int m = L, k = 32 / L; m < 32; m <<= 1, k >>= 1) {
    const bool up = lane & m;
#pragma unroll
    for (int j = 0; j < k / 2; ++j) {
      const float lo = v[2 * j], hi = v[2 * j + 1];
      const float theirs = __shfl_xor_sync(0xffffffffu, up ? lo : hi, m);
      v[j] = (up ? hi : lo) + theirs;
    }
  }
  return v[0];''')]
# No channel sum: a lane's own products added in the thread.
NO_CHANNEL_SUM = [("part[u * 32 + lane] = channel_sum<L>(v, lane);",
                   "float t_ = 0.0f;\n#pragma unroll\n"
                   "for (int q_ = 0; q_ < 2 * kS; ++q_) t_ += v[q_];\n"
                   "part[u * 32 + lane] = t_;")]
# No lane sum of d_dt, d_dtx.
NO_LANE_SUM = [('''          lane_sum<L>(vdt, g);
          lane_sum<L>(vdx, g);''', "")]
# d_dt, d_dtx summed over the lanes at every step (a packed all-reduce).
LANE_ALL_REDUCE = [('''      float vdt[L], vdx[L];
''', ""), ('''        vdt[u % L] = pdt;
        vdx[u % L] = pdx;
        part[u * 32 + lane] = channel_sum<L>(v, lane);
        if (u % L == 0) {
          // Steps tt .. tt + L - 1 summed over the channel's lanes; lane g
          // has step tt + g's. Every lane of the channel has read those
          // steps' dtx (their products fed the shuffles above).
          lane_sum<L>(vdt, g);
          lane_sum<L>(vdx, g);
          s_dt[(tt + g) * P::kRow + c] = vdt[0] * kLn2;
          s_dx[(tt + g) * P::kRow + c] = vdx[0];
        }''', '''        part[u * 32 + lane] = channel_sum<L>(v, lane);
        {
          const bool odd = g & 1;
          float sum = (odd ? pdx : pdt) +
                      __shfl_xor_sync(0xffffffffu, odd ? pdt : pdx, 1);
#pragma unroll
          for (int m = 2; m < L; m <<= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, m);
          if (g < 2)
            (odd ? s_dx : s_dt)[tt * P::kRow + c] = odd ? sum : sum * kLn2;
        }''')]
# No pass from hc: every window starts from whatever the buffer holds.
NO_PASS = [("for (int w = 0; w + 1 < nwin; ++w) {",
            "for (int w = 0; w + 1 < 0; ++w) {")]
# No per-window barrier before the block's sum of its warps.
NO_BARRIER = [('''      // Every warp's sums of the window are in; the other half of s_part
      // was last read before this barrier.
      __syncthreads();''', "")]
# No exps on the SFUs: 1 + x in their place.
NO_EXP = [('''  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));''',
           "  y = 1.0f + x;")]
# One block an SM: shared memory asked for beyond two blocks' room.
ONE_BLOCK = [("static constexpr int kSmemBytes = 4 * (2 * kStage + kPart + "
              "kCk);", "static constexpr int kSmemBytes = 4 * (2 * kStage "
              "+ kPart + kCk) + 110 * 1024;")]
# The partial sum with one load in flight at a time.
SUM_ONE_LOAD = [('''    for (int x0 = 0; x0 < blocks; x0 += kAhead) {
      float vb[kAhead], vc[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const bool ok = x0 + j < blocks;
        vb[j] = ok ? part_b[(x0 + j) * elems + e] : 0.0f;
        vc[j] = ok ? part_c[(x0 + j) * elems + e] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j)
        if (x0 + j < blocks) sb += vb[j], sc += vc[j];
    }''', '''    for (int x = 0; x < blocks; ++x) {
      sb += part_b[x * elems + e];
      sc += part_c[x * elems + e];
    }''')]
# The pass from hc unrolled over its windows.
PASS_UNROLLED = [('''#pragma unroll 1
      for (int w = 0; w + 1 < nwin; ++w) {''', '''#pragma unroll
      for (int w = 0; w + 1 < kWin; ++w) {
        if (w + 1 >= nwin) break;''')]

# (name, lanes, patches); "final" is the unpatched kernel.
VARIANTS = [
    ("final", 4, []),
    ("selects", 4, SELECTS),
    ("no_channel_sum", 4, NO_CHANNEL_SUM),
    ("no_lane_sum", 4, NO_LANE_SUM),
    ("lane_all_reduce", 4, LANE_ALL_REDUCE),
    ("no_pass", 4, NO_PASS),
    ("no_barrier", 4, NO_BARRIER),
    ("no_exp", 4, NO_EXP),
    ("one_block", 4, ONE_BLOCK),
    ("sum_one_load", 4, SUM_ONE_LOAD),
    ("pass_unrolled", 4, PASS_UNROLLED),
    ("final_8_lanes", 8, []),
    ("final_again", 4, []),
]


def build(name: str, patches) -> tuple:
    """Compile the patched copy; return (the entry point, ptxas lines)."""
    d = OUT_DIR / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.SRC_DIR, d)
    path = d / "selective_scan_bwd.cu"
    src = path.read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: patch does not apply: {old[:60]!r}")
        src = src.replace(old, new)
    path.write_text(src)
    so = d / "libvariant.so"
    run = subprocess.run([str(smoke_nvcc()), *_build.NVCC_FLAGS, "-shared",
                          str(path), "-o", str(so)], capture_output=True,
                         text=True)
    if run.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{run.stdout}{run.stderr}")
    fn = ctypes.CDLL(str(so)).selective_scan_bwd
    fn.argtypes, fn.restype = _build._SIGNATURES["selective_scan_bwd"]
    return fn, [ln for ln in smoke.ptxas_report(run.stdout + run.stderr)
                if "bwd" in ln]


def smoke_nvcc() -> Path:
    from repro_torch import probes

    nvcc = probes.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    return Path(nvcc)


def inputs(dev):
    """scan_train_checks' inputs at the training shape, and hc from K9."""
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 7)
    b, seq, di, n = smoke.TRAIN_BATCH, smoke.TRAIN_SEQ, 8192, 16
    u = torch.rand((b, seq, di), generator=gen, device=dev)
    dt = torch.exp(math.log(1e-3) + u * math.log(100.0))
    dtx = dt * torch.randn((b, seq, di), generator=gen, device=dev)
    Bm = torch.randn((b, seq, n), generator=gen, device=dev)
    Cm = torch.randn((b, seq, n), generator=gen, device=dev)
    A_t = -(torch.arange(1, n + 1, device=dev, dtype=torch.float32)[:, None]
            * (1.0 + 0.1 * torch.rand((n, di), generator=gen, device=dev)))
    dy = torch.randn((b, seq, di), generator=gen, device=dev)
    _, _, hc = ks.selective_scan(dt, dtx, Bm, Cm, A_t,
                                 torch.zeros((b, n, di), device=dev),
                                 chunk_states=True)
    return dt, dtx, Bm, Cm, A_t, hc, dy


def caller(fn, lanes: int, args):
    """A closure that runs ``fn`` on ``args`` into fresh outputs."""
    dt, dtx, Bm, Cm, A_t, hc, dy = args
    b, seq, di = dt.shape
    n = A_t.shape[0]
    outs = [torch.empty_like(dt), torch.empty_like(dt), torch.empty_like(Bm),
            torch.empty_like(Cm)]
    blocks, _, _ = ks.bwd_schedule(b, di, lanes)
    part = torch.empty((2, blocks, b, seq, n), device=dt.device)
    stream = _build.stream_of(dt)

    def call():
        _build.check(fn(*(t.data_ptr() for t in (dt, dtx, Bm, Cm, A_t, hc,
                                                 dy, *outs, part[0],
                                                 part[1])),
                        ks.STATE_EVERY, b, seq, di, n, lanes, stream),
                     "selective_scan_bwd variant")
    return call, outs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "scan_bwd_variants.json")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_bwd_variants: torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    args = inputs(dev)
    ref = ks.selective_scan_bwd(*args)
    rows = []
    for name, lanes, patches in VARIANTS:
        fn, ptxas = build(name, patches)
        call, outs = caller(fn, lanes, args)
        call()
        torch.cuda.synchronize()
        rel = [smoke.max_err(o, r)[0] / smoke.max_err(o, r)[1]
               for o, r in zip(outs, ref)]
        ms = [smoke.time_ms(call) for _ in range(3)]
        prof = smoke.profile(lambda: [call() for _ in range(5)], name,
                             echo=False)
        device = {("sum" if "sum_kernel" in k["name"] else "main"):
                  k["ms"] / k["launches"]
                  for k in prof.get("top_kernels_ms", [])
                  if "selective_scan_bwd" in k["name"]}
        row = {"name": name, "lanes": lanes, "ms": ms, "device_ms": device,
               "rel_err": rel, "ptxas": ptxas}
        rows.append(row)
        print(json.dumps(row), flush=True)
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
