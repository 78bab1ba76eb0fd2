"""AdamW for DoRA fine-tuning (counterpart of ``repro/optim/adamw.py``):
adapter leaves only, the frozen base model carries no optimizer state.

The same tree and arithmetic as the reference: fp32 moments ``mu`` and
``nu`` for every adapter leaf and an int32 ``count``; a linear-warmup
cosine schedule evaluated in fp32; a global-norm clip in fp32 cast back to
each gradient's dtype; decoupled weight decay, masked off the magnitude
``m`` and the frozen ``base_sq``; the update in fp32 cast back to the
parameter's dtype. Where JAX returns new arrays, :func:`adamw_update`
writes the parameters and the moments IN PLACE, under
``torch.no_grad()``, and returns the same trees: at qwen2-7b r=384 that
saves a second copy of 1.9 GB of adapters and 7.7 GB of moments.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.tree import flatten_paths, tree_map

_F32 = torch.float32
_f32 = np.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1e-4
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float | None = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_warmup_schedule(cfg: OptimizerConfig, step) -> float:
    """Linear warmup → cosine decay to min_lr_ratio·lr, in fp32 in the
    reference's order; the fp32 value is returned as a Python float."""
    step = _f32(step)
    warm = min(step / _f32(max(cfg.warmup_steps, 1)), _f32(1.0))
    prog = np.clip((step - _f32(cfg.warmup_steps))
                   / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   _f32(0.0), _f32(1.0))
    cos = _f32(0.5) * (_f32(1.0) + np.cos(_f32(math.pi) * prog))
    scale = _f32(cfg.min_lr_ratio) + _f32(1.0 - cfg.min_lr_ratio) * cos
    return float(_f32(cfg.lr) * warm * scale)


def global_norm(tree) -> torch.Tensor:
    """fp32 0-d tensor: sqrt of the sum of every leaf's squares."""
    leaves = list(flatten_paths(tree).values())
    return torch.sqrt(sum(leaf.to(_F32).square().sum() for leaf in leaves))


def clip_by_global_norm(grads, max_norm: float, *, norm=None):
    """(grads scaled by min(1, max_norm/norm) in fp32 and cast back,
    norm). ``norm``: the global norm when the caller took it across
    shards."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return tree_map(lambda g: (g.to(_F32) * scale).to(g.dtype), grads), norm


def _default_wd_mask(path: tuple[str, ...], leaf) -> bool:
    """Decay A/B matrices; skip the magnitude vector m (norm-like) and
    the frozen base_sq cache (constant, zero grad)."""
    return path[-1] not in ("m", "base_sq")


def adamw_init(params) -> dict[str, Any]:
    """fp32 zero moments for every adapter leaf and an int32 count."""
    zeros = lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32)}


@torch.no_grad()
def adamw_update(grads, state, params, cfg: OptimizerConfig, *,
                 wd_mask=None, grad_norm=None):
    """One AdamW step, in place. Returns (params, state, stats) with
    stats {"lr": float, "grad_norm": fp32 0-d tensor (before the clip)}.
    ``grad_norm``: the global norm when the trees are one rank's shards
    and the caller summed it across them.

    ``wd_mask(path, leaf) -> bool``: True = apply weight decay (default:
    everything except ``m`` and ``base_sq``); ``path`` is the tuple of
    the leaf's keys."""
    wd_mask = wd_mask or _default_wd_mask
    count = int(state["count"]) + 1
    lr = cosine_warmup_schedule(cfg, count)

    pre_norm = global_norm(grads) if grad_norm is None else grad_norm
    if cfg.clip_norm is not None:
        grads, _ = clip_by_global_norm(grads, cfg.clip_norm, norm=pre_norm)

    b1, b2 = cfg.betas
    c1 = float(_f32(1.0) - _f32(b1) ** _f32(count))
    c2 = float(_f32(1.0) - _f32(b2) ** _f32(count))

    flat_p = flatten_paths(params)
    flat_g = flatten_paths(grads)
    flat_mu = flatten_paths(state["mu"])
    flat_nu = flatten_paths(state["nu"])
    for name, p in flat_p.items():
        g32 = flat_g[name].to(_F32)
        mu, nu = flat_mu[name], flat_nu[name]
        mu.mul_(b1).add_((1 - b1) * g32)
        nu.mul_(b2).add_((1 - b2) * g32 * g32)
        step = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        if cfg.weight_decay and wd_mask(tuple(name.split("/")), p):
            step = step + cfg.weight_decay * p.to(_F32)
        p.copy_((p.to(_F32) - lr * step).to(p.dtype))

    state["count"] = torch.full_like(state["count"], count)
    return params, state, {"lr": lr, "grad_norm": pre_norm}
