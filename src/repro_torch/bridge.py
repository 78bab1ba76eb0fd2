"""Carry weights and optimizer state between the reference's pytrees and
the port's trees.

The reference's ``params`` / ``adapters`` / AdamW state (``mu``, ``nu``,
``count``) / decode cache trees (K/V, or the Mamba ``h`` and ``conv``
states, and ``len``), given as nested dicts of numpy arrays (``np.asarray``
of each JAX leaf), become the port's trees of tensors on a chosen device
(:func:`tree_from_numpy`), and back (:func:`tree_to_numpy`). Leaves are
keyed by the same "/"-joined paths that the reference's checkpoints write
(``repro/checkpoint/store.py``), so :func:`flatten_paths` of either tree
names the same leaves. Leaf shapes are carried as they are, so the
K-stacked serving trees of multi-tenant serving (leaves [n_scan, K, ...],
``stack_adapter_states(..., axis=1)`` in either package) cross both ways.

bf16 arrays (numpy dtype ``bfloat16`` from ``ml_dtypes``, which
``torch.from_numpy`` refuses) are carried bit for bit as uint16 and
viewed back as ``torch.bfloat16``: the conversion is exact both ways.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.tree import flatten_paths, unflatten_paths

__all__ = ["tensor_from_numpy", "tensor_to_numpy", "tree_from_numpy",
           "tree_to_numpy", "flatten_paths", "unflatten_paths"]


def tensor_from_numpy(arr, device=None) -> torch.Tensor:
    """One array → tensor, exactly; bf16 goes through a uint16 view. On
    the CPU the tensor shares memory with a writable C-contiguous array
    (as ``torch.from_numpy``), so an in-place update (the train step's)
    writes through; a read-only array (a JAX buffer) is copied first."""
    # np.require keeps a 0-d array 0-d (np.ascontiguousarray makes it 1-d).
    arr = np.require(arr, requirements=["C", "W"])
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device) if device is not None else t


def tree_from_numpy(tree: Mapping[str, Any], device=None) -> dict:
    """The reference's nested dict of arrays → the port's nested dict of
    tensors on ``device``, leaf paths unchanged."""
    return unflatten_paths({name: tensor_from_numpy(leaf, device)
                            for name, leaf in flatten_paths(tree).items()})


def tensor_to_numpy(t) -> np.ndarray:
    """One tensor → a numpy array on the host, exactly. bf16 becomes
    numpy ``bfloat16`` (``ml_dtypes``, imported only here) through a
    uint16 view. A Python scalar (a decode cache's scalar "len") becomes
    a 0-d array."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def tree_to_numpy(tree: Mapping[str, Any]) -> dict:
    """The port's nested dict of tensors → nested dict of numpy arrays,
    leaf paths unchanged (for the reference or for comparisons)."""
    return unflatten_paths({name: tensor_to_numpy(leaf)
                            for name, leaf in flatten_paths(tree).items()})
