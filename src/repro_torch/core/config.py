"""DoRA adapter configuration (counterpart of ``repro/core/config.py``).

The same fields, validation and derived quantities as the reference, with
three port-specific differences:

  - modes are ``auto | fused | eager``. The reference's ``interpret``
    mode runs the Pallas interpreter; the port has no interpreter, so the
    mode is refused with that reason. ``fused`` is the hand-written CUDA
    kernels; on CPU tensors their wrappers run the kernels' plain PyTorch
    versions, which is how the CPU tests exercise the kernel route.
  - the port reads its OWN override, ``REPRO_TORCH_FORCE_TIER``. The
    reference's ``REPRO_FORCE_TIER`` / ``REPRO_DORA_MODE`` /
    ``REPRO_DORA_FUSED`` / ``REPRO_DORA_NORM_CHUNK_MB`` are not read, so a
    CI leg that forces the reference's interpreter never reaches the port.
  - the block knobs keep the reference's values because the dispatch rank
    guard (``resolve_mm_fused_max_rank``) is defined by them; the CUDA
    kernels choose their own tiles.
"""
from __future__ import annotations

import dataclasses
import math
import os

FORCE_TIER_ENV = "REPRO_TORCH_FORCE_TIER"


def shrink_block_rows(block_m: int, rows: int | None) -> int:
    """Decode-aware row-tile shrink: the block never exceeds the row count
    rounded up to a multiple of 8 (the reference's sublane rule, kept so
    the rank guard prices the same tiles)."""
    if rows is None:
        return block_m
    return min(block_m, max(8, (rows + 7) // 8 * 8))


_INTERPRET_REFUSED = (
    "the port has no Pallas interpreter; use 'fused' (the CUDA kernels, "
    "whose wrappers run the plain PyTorch versions on CPU tensors) or "
    "'eager'")

# Tier names → config modes. "cuda"/"fused" mean the hand-written kernels.
_TIER_ALIASES = {"cuda": "fused", "fused": "fused", "eager": "eager"}


def _normalize_tier(tier: str) -> str | None:
    return _TIER_ALIASES.get(tier.strip().lower())


@dataclasses.dataclass(frozen=True)
class DoRAConfig:
    """Configuration for DoRA adaptation of a linear layer family."""

    rank: int = 384
    alpha: float = 192.0
    rslora: bool = True

    # --- dispatch (paper §4, Table 2) ---
    # "auto": CUDA kernels for CUDA tensors above the crossover, eager
    #         otherwise (and always eager for CPU tensors).
    # "fused": force the kernel route at every supported shape.
    # "eager": force the plain PyTorch (Tier-3) path.
    mode: str = "auto"
    # Forced kernel tier ("cuda"/"fused" | "eager"); overrides ``mode``.
    # REPRO_TORCH_FORCE_TIER overrides both.
    force_tier: str | None = None
    # Crossover below which launch latency dominates (paper §4).
    min_fused_dout: int = 2048
    min_fused_elems: int = 2048 * 6144

    # --- norm (paper §2) ---
    norm_impl: str = "factored"        # "factored" | "dense_ba" | "peft_eye"
    norm_chunk_mb: int | None = 256
    cache_base_norm: bool = False

    # --- compose (paper §3) ---
    save_inner: bool = True
    magnitude_trainable: bool = True
    dropout: float = 0.0
    compose_matmul_fused: bool = True
    mm_fused_max_rank: int | None = None

    # --- block shapes the dispatch guard is priced at ---
    block_rows: int = 256
    block_cols: int = 1024
    mm_block_rows: int | None = None
    norm_block_rows: int = 256
    norm_block_k: int = 512

    def __post_init__(self):
        if self.rank <= 0:
            raise ValueError(f"rank must be positive, got {self.rank}")
        if self.mode == "interpret":
            raise ValueError(f"mode 'interpret' is refused: "
                             f"{_INTERPRET_REFUSED}")
        if self.mode not in ("auto", "fused", "eager"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.force_tier is not None:
            _check_tier(self.force_tier, "force_tier")
        if self.norm_impl not in ("factored", "dense_ba", "peft_eye"):
            raise ValueError(f"unknown norm_impl {self.norm_impl!r}")
        if self.mm_block_rows is not None and self.mm_block_rows <= 0:
            raise ValueError(
                f"mm_block_rows must be positive, got {self.mm_block_rows}")
        if self.dropout != 0.0:
            raise NotImplementedError(
                "dropout routes to the chunked eager path (paper App. B); "
                "only p=0 is wired in this repro")

    @property
    def scaling(self) -> float:
        """LoRA scaling s: alpha/rank, or alpha/sqrt(rank) under rsLoRA."""
        if self.rslora:
            return self.alpha / math.sqrt(self.rank)
        return self.alpha / self.rank

    def resolve_mode(self) -> str:
        """Precedence: REPRO_TORCH_FORCE_TIER > ``force_tier`` > ``mode``."""
        env = os.environ.get(FORCE_TIER_ENV)
        if env:
            return _check_tier(env, FORCE_TIER_ENV)
        if self.force_tier is not None:
            return _normalize_tier(self.force_tier)
        return self.mode

    def resolve_mm_block_rows(self, rows: int | None = None) -> int:
        """block_m of the matmul-fused compose as the rank guard prices it,
        shrunk for decode-shaped call sites."""
        bm = self.mm_block_rows if self.mm_block_rows is not None \
            else self.block_rows
        return shrink_block_rows(bm, rows)

    def resolve_mm_fused_max_rank(self, rows: int | None = None) -> int:
        """Rank crossover for the matmul-fused compose: explicit override
        or the bytes-model bound 2·block_m at the call site's block."""
        if self.mm_fused_max_rank is not None:
            return self.mm_fused_max_rank
        return 2 * self.resolve_mm_block_rows(rows)

    def resolve_chunk_mb(self) -> int | None:
        return self.norm_chunk_mb


def _check_tier(tier: str, source: str) -> str:
    if tier.strip().lower() == "interpret":
        raise ValueError(f"{source}={tier!r} is refused: "
                         f"{_INTERPRET_REFUSED}")
    mode = _normalize_tier(tier)
    if mode is None:
        raise ValueError(f"{source}={tier!r} is not a known tier "
                         f"(expected 'cuda'/'fused' or 'eager')")
    return mode
