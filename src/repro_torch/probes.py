"""Capability probes for the CUDA route (counterpart of
``repro/compat/probes.py``).

Probes never raise; :func:`require_cuda` turns a missing capability into
an error that names the reason. The hand-written kernels target Hopper
(``sm_90a``), so the card must report compute capability (9, 0).
"""
from __future__ import annotations

import os
import shutil

import torch

REQUIRED_CAPABILITY = (9, 0)


def cuda_available() -> bool:
    return torch.cuda.is_available()


def capability(index: int = 0) -> tuple[int, int] | None:
    """Compute capability of card ``index``, or None without CUDA."""
    if not cuda_available():
        return None
    return tuple(torch.cuda.get_device_capability(index))


def device_name(index: int = 0) -> str | None:
    if not cuda_available():
        return None
    return torch.cuda.get_device_name(index)


def nvcc_path() -> str | None:
    """The CUDA compiler: ``PATH`` first, then ``$CUDA_HOME/bin`` and
    ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return None


def why_unavailable(index: int = 0) -> str | None:
    """Why the kernels cannot run on card ``index``; None when they can."""
    if not cuda_available():
        if torch.version.cuda is None:
            return (f"torch {torch.__version__} is built without CUDA")
        return "torch sees no CUDA device"
    cap = capability(index)
    if cap != REQUIRED_CAPABILITY:
        return (f"card {index} ({device_name(index)}) has compute "
                f"capability {cap}; the kernels are built for sm_90a and "
                f"need {REQUIRED_CAPABILITY}")
    return None


def require_cuda(index: int = 0) -> None:
    """Raise RuntimeError naming the reason when CUDA card ``index`` cannot
    run the port's kernels."""
    reason = why_unavailable(index)
    if reason is not None:
        raise RuntimeError(f"CUDA unavailable: {reason}")


def report() -> dict:
    """Everything the probes see, for logs and the chip smoke."""
    return {"cuda": cuda_available(), "capability": capability(),
            "device": device_name(), "nvcc": nvcc_path(),
            "torch": torch.__version__, "torch_cuda": torch.version.cuda}
