"""Build and bind the hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together) and linked into ONE shared library with a
plain C interface, loaded with ``ctypes``. The build runs once, at the
first kernel launch, never at import. The library lands in
``build/repro_torch/`` at the repository root under a name that carries a
hash of the sources and flags, so a stale library is never loaded.

Every C entry point returns ``cudaGetLastError()``; :func:`check` raises
when it is not 0.

A launch is paced by the host where the kernel is short, so the helpers
every wrapper calls keep its host path near one PyTorch op's: the card is
probed once per device index (a probe that fails is never remembered),
the stream handle is read raw, and :func:`no_grad` costs nothing where
grad mode is already off (serving, and autograd Functions' passes).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch import probes

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Element type codes of csrc/common.cuh (enum DTypeCode).
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of the entry points: (argtypes, restype).
_SIGNATURES = {
    "norm_terms": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P), _I),
    "norm_terms_assemble": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _F, _F, _P), _I),
    "assemble_norm": ((_P, _P, _P, _P, _I, _F, _F, _P), _I),
    "compose_fwd": ((_P, _P, _P, _P, _L, _I, _F, _I, _I, _P), _I),
    "compose_fwd_dual": ((_P, _P, _P, _P, _P, _L, _I, _F, _I, _I, _P), _I),
    "compose_bwd": ((_P, _P, _P, _P, _P, _L, _I, _I, _I, _P), _I),
    "compose_mm_fwd": ((_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P),
                       _I),
    "compose_mm_bwd": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
                       _I),
    "paged_gather": ((_P, _P, _P, _L, _L, _L, _P), _I),
    "selective_scan": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _P), _I),
    "selective_scan_bwd": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _I, _I, _I, _I, _I, _I, _P), _I),
    "selective_scan_bwd_occupancy": ((_I, _P), _I),
    "runtime_error_string": ((_I,), ctypes.c_char_p),
}


# SMs a split grid fills: the H100's 132, one resident block each (the
# tensor-core kernels' shared memory allows no second).
SMS = 132
# A block's fixed cost in k-tiles of work (filling its pipeline, folding
# or writing its output tile, writing its partials), fitted to the split
# sweep that chip_smoke.py times on the H100.
BLOCK_COST = 16


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.cache
def split_plan(tiles: int, k: int, tile_k: int) -> tuple[int, int]:
    """(splits, split_len) for a grid of ``tiles`` output tiles that sums
    over an axis of length ``k`` > 0, cut into contiguous ranges of
    ``split_len``, a multiple of ``tile_k`` (the last range may be
    shorter). Among the cuts that put a block on each of the :data:`SMS`
    SMs (or, where none can, among all), it takes the one whose grid ends
    soonest when blocks run in waves of :data:`SMS`: waves x (k-tiles a
    block + :data:`BLOCK_COST`), fewer splits on a tie."""
    k_tiles = cdiv(k, tile_k)

    def rank(per):                      # per: k-tiles a split
        blocks = tiles * cdiv(k_tiles, per)
        return (blocks < SMS, cdiv(blocks, SMS) * (per + BLOCK_COST),
                -per)

    per = min(range(1, k_tiles + 1), key=rank)
    return cdiv(k_tiles, per), per * tile_k


def tensor_cores(*tensors: torch.Tensor, dims=()) -> bool:
    """Whether operands can take a bf16 tensor-core kernel: bf16, every
    pointer 16-byte aligned and every dimension in ``dims`` (the
    contiguous ones, copied in 16-byte chunks) a multiple of 8."""
    return (tensors[0].dtype == torch.bfloat16
            and all(t.data_ptr() % 16 == 0 for t in tensors)
            and all(d % 8 == 0 for d in dims))


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(SRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libreprotorch_{source_hash()}.so"


def build() -> Path:
    """Compile and link the library if it is not there yet; return its
    path. The compiler's output (ptxas register and spill counts included)
    is kept beside it in a ``.log`` file."""
    out = library_path()
    if out.exists():
        return out
    nvcc = probes.nvcc_path()
    if nvcc is None:
        raise RuntimeError("cannot build the CUDA kernels: nvcc not found "
                           "on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name} (exit {proc.returncode})\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", *map(str, objs), "-o",
             str(tmp_lib)], capture_output=True, text=True)
        log.append(f"== link (exit {link.returncode})\n{link.stdout}"
                   f"{link.stderr}")
        if link.returncode != 0:
            raise RuntimeError("linking the kernels failed:\n"
                               + "\n".join(log))
        os.replace(tmp_lib, out)
    out.with_suffix(".log").write_text("\n".join(log))
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The built library with every entry point's C signature declared."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(rc: int, kernel: str) -> None:
    if rc != 0:
        msg = library().runtime_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc} "
                           f"({msg})")


def no_grad(fn):
    """``torch.no_grad()`` as a decorator, at the cost of one grad-mode
    read where grad mode is already off (``torch.no_grad()`` itself costs
    a few microseconds a call, as much as a short kernel)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        with torch.no_grad():
            return fn(*args, **kwargs)
    return run


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device, read
    on every call (it follows ``torch.cuda.stream`` contexts) without
    building a ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


# Device indices whose probe passed. A probe that fails is not kept, so it
# runs and raises again on every call.
_probed: set[int] = set()


def require_card(index: int) -> None:
    """:func:`probes.require_cuda` once per device index that passes it."""
    if index not in _probed:
        probes.require_cuda(index)
        _probed.add(index)


def check_operands(kernel: str, *tensors: torch.Tensor, dtype=None) -> None:
    """Every operand on one CUDA device, contiguous, and (where ``dtype``
    is given) of that dtype; raise naming what is wrong."""
    dev = tensors[0].device
    require_card(dev.index or 0)
    for i, t in enumerate(tensors):
        if t.device != dev:
            raise ValueError(f"{kernel}: operand {i} is on {t.device}, "
                             f"operand 0 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operand {i} is not contiguous")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{kernel}: operand {i} has dtype {t.dtype}, "
                            f"expected {dtype}")


def dtype_code(kernel: str, t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODE:
        raise TypeError(f"{kernel}: dtype {t.dtype} is not supported "
                        f"(expected one of {list(DTYPE_CODE)})")
    return DTYPE_CODE[t.dtype]
