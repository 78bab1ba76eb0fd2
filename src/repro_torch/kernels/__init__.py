"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version, and the wrappers the model calls (:mod:`.ops`).

Every kernel wrapper keeps a plain integer ``launches`` that it increments
where it launches its kernel and nowhere else; :func:`launch_counts` reads
them and :func:`reset_launch_counts` zeroes them (and K1's
``norm_terms.assembled_launches``, its launches that ended in the norm
assembly), so a run can show which kernels its path went through.
"""
from __future__ import annotations

from repro_torch.kernels.dora_compose import (compose_bwd, compose_fwd,
                                              compose_fwd_dual,
                                              compose_mm_bwd, compose_mm_fwd)
from repro_torch.kernels.factored_norm import norm_terms
from repro_torch.kernels.norm_assembly import assemble_norm
# The modules, not their wrappers, keep the names ``kernels.paged_gather``
# and ``kernels.selective_scan``.
from repro_torch.kernels import paged_gather as _paged
from repro_torch.kernels import selective_scan as _scan

# name → wrapper, in the order of the TPU kernel table (K1–K9), then the
# scan's backward, which has no TPU counterpart (the reference
# differentiates its XLA scan).
KERNELS = {"norm_terms": norm_terms, "assemble_norm": assemble_norm,
           "compose_fwd": compose_fwd, "compose_fwd_dual": compose_fwd_dual,
           "compose_bwd": compose_bwd, "compose_mm_fwd": compose_mm_fwd,
           "compose_mm_bwd": compose_mm_bwd,
           "paged_gather": _paged.paged_gather,
           "selective_scan": _scan.selective_scan,
           "selective_scan_bwd": _scan.selective_scan_bwd}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    norm_terms.assembled_launches = 0
