"""Gradient compression for the cross-pod all-reduce (counterpart of
``repro/optim/compression.py``).

The adapter gradients are summed over (pod, data); the pod axis crosses
the slow link between pods. Two schemes:

  - **bf16 cast**: half the bytes, stateless.
  - **int8 + error feedback**: per-tensor symmetric quantization with a
    residual carried across steps (Seide et al.), so the quantization
    error is re-injected instead of lost; a quarter of fp32's bytes.

Both compress before the cross-pod reduce and decompress after; the
within-pod reduce stays fp32. :func:`cross_pod_sync` is the sync of
``examples/grad_compression_dp.py`` over a (pod, data) mesh of ranks: an
fp32 mean over ``data``, then an int8 payload and one fp32 scale per pod
on the pod axis, each built on ``all_reduce``
(``core/sharding.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core import sharding as _sh
from repro_torch.tree import tree_map

_F32 = torch.float32


def compress_bf16(grads):
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def decompress_bf16(grads):
    return tree_map(lambda g: g.to(_F32), grads)


def init_error_feedback(grads_like):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=_F32,
                                          device=g.device), grads_like)


def _quantize_one(g, ef):
    """Symmetric per-tensor int8 with the error-feedback residual."""
    corrected = g.to(_F32) + ef
    scale = torch.clamp_min(corrected.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(
        torch.int8)
    return q, scale, corrected


def int8_ef_compress(grads, ef):
    """(q tree int8, scale tree fp32 0-d, corrected tree fp32); the
    decompress step takes ``corrected`` to form the new residual."""
    flat = tree_map(_quantize_one, grads, ef)
    return tuple(_leaf_map(flat, i) for i in range(3))


def _leaf_map(tree, i):
    if isinstance(tree, dict):
        return {k: _leaf_map(v, i) for k, v in tree.items()}
    return tree[i]


def int8_ef_decompress(q, scale, corrected):
    """(dequantized tree, new error-feedback residual tree)."""
    deq = tree_map(lambda qi, s: qi.to(_F32) * s, q, scale)
    new_ef = tree_map(lambda c, d: c - d, corrected, deq)
    return deq, new_ef


def cross_pod_sync(grads, mesh, ef=None):
    """Average ``grads`` over the (pod, data) ranks of ``mesh``: fp32 over
    ``data``, then int8 with error feedback over ``pod`` (each pod's
    payload and scale gathered, dequantized and averaged). Returns
    (grads fp32, new residual tree, or ``ef`` as given without a pod
    axis)."""
    data = tuple(a for a in ("data",) if a in mesh.axis_names)
    n_data = mesh.axis_size(data) if data else 1
    g = tree_map(lambda x: _sh.psum(x.to(_F32), data, mesh,
                                    tag="grad.data") / n_data, grads)
    if "pod" not in mesh.axis_names or mesh.axis_size("pod") == 1:
        return g, ef
    if ef is None:
        ef = init_error_feedback(g)
    q, scale, corrected = int8_ef_compress(g, ef)
    _, new_ef = int8_ef_decompress(q, scale, corrected)

    def over_pods(qi, s):
        qs = _sh.all_gather(qi[None].contiguous(), ("pod",), mesh, 0,
                            tag="grad.pod")
        ss = _sh.all_gather(s.reshape(1), ("pod",), mesh, 0,
                            tag="grad.pod_scale")
        return (qs.to(_F32) * ss.reshape((-1,) + (1,) * qi.ndim)).mean(
            dim=0)

    return tree_map(over_pods, q, scale), new_ef
