"""Three-tier runtime dispatch (paper §4); counterpart of
``repro/core/dispatch.py``.

Tier 1 — fused backward: training on the kernel route (autograd
         Functions whose backward is a kernel too: K5 or K7).
Tier 2 — fused forward: inference on the kernel route (g detached).
Tier 3 — eager: forced off, CPU tensors in auto mode, sub-crossover
         shapes, d_out % 128 != 0.

Two backends: ``cuda`` (the hand-written kernels in
:mod:`repro_torch.kernels`) and ``eager`` (plain PyTorch). The plan depends
only on the config, the shapes and the tensors' device type, and makes
the same tier and ``matmul_fused`` decisions as the reference's plan for
the same (config, rows, d_out, rank) on its accelerator. In auto mode CPU
tensors take the eager backend: that is the caller's choice of device,
not a fallback. A forced kernel tier on CPU tensors keeps the kernel
route, whose wrappers then run the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
import enum

import torch

from repro_torch.core.config import DoRAConfig
from repro_torch.core.sharding import ComposeSharding


class Tier(enum.Enum):
    FUSED_BWD = 1
    FUSED_FWD = 2
    EAGER = 3


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Resolved execution plan for one kernel call site."""
    tier: Tier
    backend: str                  # "cuda" | "eager"
    # The LoRA up-projection h@Bᵀ runs inside the compose kernel.
    matmul_fused: bool = False
    # The call site's mesh plan, attached only to a matmul-fused plan
    # whose shapes it can run shard-local (``kernel_expressible``).
    sharding: ComposeSharding | None = None

    @property
    def fused(self) -> bool:
        return self.tier is not Tier.EAGER


def resolve_backend(cfg: DoRAConfig, device) -> str:
    """Mode → backend name. Auto picks ``cuda`` for CUDA tensors and
    ``eager`` for CPU tensors; a forced mode is honoured as given."""
    mode = cfg.resolve_mode()
    if mode == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "eager"
    return "cuda" if mode == "fused" else "eager"


def above_crossover(rows: int, d_out: int, cfg: DoRAConfig) -> bool:
    """Paper §4: d_out >= 2048 and rows*d_out >= 2048*6144."""
    return (d_out >= cfg.min_fused_dout
            and rows * d_out >= cfg.min_fused_elems)


def shape_supported(d_out: int) -> bool:
    """Paper App. C: d_out must divide the 128-lane block. The CUDA
    kernels mask ragged edges, but the constraint is kept so the port
    routes every shape as the reference does."""
    return d_out % 128 == 0


def mm_fused_eligible(rank: int | None, cfg: DoRAConfig,
                      rows: int | None = None) -> bool:
    """Rank guard for the matmul-fused compose. The rank is priced padded
    to 128 as in the reference (whose kernel pads it), although the CUDA
    kernel takes r as given: a padding change must not move the plan."""
    if rank is None or not cfg.compose_matmul_fused:
        return False
    rank_padded = (rank + 127) // 128 * 128
    return rank_padded <= cfg.resolve_mm_fused_max_rank(rows)


def plan_compose(cfg: DoRAConfig, *, training: bool, rows: int,
                 d_out: int, rank: int | None = None,
                 sharding: ComposeSharding | None = None,
                 device="cuda") -> KernelPlan:
    """Resolve the compose call site. The shape constraint outranks a
    forced tier; ``rank`` is given when the caller still holds the
    factored ``h = x@Aᵀ``.

    ``sharding``: the call site's plan (``rows`` and ``d_out`` are then
    the whole tensor's, as in the reference). A plan whose local d_out
    breaks the 128-lane rule, or whose row axes do not divide ``rows``,
    takes the eager route; otherwise the route is chosen as the
    reference's is (the crossover on the whole shape, the rank guard on
    the local rows) and a matmul-fused plan carries the sharding."""
    rows_local = rows
    if sharding is not None:
        row_shards = max(sharding.row_shards, 1)
        if not sharding.kernel_expressible(d_out) or rows % row_shards:
            return KernelPlan(Tier.EAGER, "eager")
        rows_local = rows // row_shards
    local_dout = sharding.local_dout(d_out) if sharding is not None \
        else d_out
    if not shape_supported(local_dout):
        return KernelPlan(Tier.EAGER, "eager")
    backend = resolve_backend(cfg, device)
    if backend == "eager":
        return KernelPlan(Tier.EAGER, "eager")
    if cfg.resolve_mode() == "auto" and not above_crossover(rows, d_out,
                                                             cfg):
        return KernelPlan(Tier.EAGER, "eager")
    tier = Tier.FUSED_BWD if training else Tier.FUSED_FWD
    mm = mm_fused_eligible(rank, cfg, rows_local)
    return KernelPlan(tier, backend, matmul_fused=mm,
                      sharding=sharding if mm else None)


def select_tier(cfg: DoRAConfig, *, training: bool, rows: int,
                d_out: int, device="cuda") -> Tier:
    """The tier :func:`plan_compose` chooses (``repro/core/dispatch.py:221``)."""
    return plan_compose(cfg, training=training, rows=rows, d_out=d_out,
                        device=device).tier


def _plan_fwd_only(cfg: DoRAConfig, device) -> KernelPlan:
    """A forward-only call site (Tier 2) on the kernel route, or eager."""
    backend = resolve_backend(cfg, device)
    if backend == "eager":
        return KernelPlan(Tier.EAGER, "eager")
    return KernelPlan(Tier.FUSED_FWD, backend)


def plan_norm(cfg: DoRAConfig, *, d_out: int, device="cuda") -> KernelPlan:
    """Resolve the factored-norm call site: forward-only (Tier 2) with no
    crossover guard (paper §2.3)."""
    if not shape_supported(d_out):
        return KernelPlan(Tier.EAGER, "eager")
    return _plan_fwd_only(cfg, device)


def plan_gather(cfg: DoRAConfig | None, *, head_elems: int,
                device="cuda") -> KernelPlan:
    """Resolve the paged K/V gather call site (block pool → logical view,
    K8). Forward-only (the cache carries no gradient), so the kernel
    choice is Tier 2, like the norm. ``head_elems`` = Hkv·hd, the
    flattened trailing dim of one cache block, must divide the 128-lane
    block; an unsupported shape, and ``cfg=None`` (a base model served
    without an adapter config), take the plain gather, which is bitwise
    the kernel (both are copies with a zero fill)."""
    if cfg is None or not shape_supported(head_elems):
        return KernelPlan(Tier.EAGER, "eager")
    return _plan_fwd_only(cfg, device)


def plan_scan(cfg: DoRAConfig | None, *, device="cuda") -> KernelPlan:
    """Resolve the selective-scan call site of a Mamba layer (K9).
    Forward-only (no backward kernel exists for it), so the kernel choice
    is Tier 2. Auto mode and a forced kernel mode take the ``cuda``
    backend, whose wrapper launches K9 on CUDA tensors and runs its plain
    version on CPU tensors; the eager mode (``mode`` or
    ``REPRO_TORCH_FORCE_TIER``) takes the plain scan. ``cfg=None`` (a base
    model served without an adapter config) is auto mode: the device
    decides. Nothing switches on failure."""
    return _plan_fwd_only(cfg if cfg is not None else DoRAConfig(), device)
