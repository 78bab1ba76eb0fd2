"""Carry weights from the reference's pytrees into the port's trees.

The reference's ``params`` / ``adapters`` trees, given as nested dicts of
numpy arrays (``np.asarray`` of each JAX leaf), become the port's trees of
tensors on a chosen device. Leaves are keyed by the same "/"-joined paths
that the reference's checkpoints write (``repro/checkpoint/store.py``),
so :func:`flatten_paths` of either tree names the same leaves.

bf16 arrays (numpy dtype ``bfloat16`` from ``ml_dtypes``, which
``torch.from_numpy`` refuses) are carried bit for bit as uint16 and
viewed back as ``torch.bfloat16``: the conversion is exact.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def tensor_from_numpy(arr, device=None) -> torch.Tensor:
    """One array → tensor, exactly; bf16 goes through a uint16 view."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device) if device is not None else t


def flatten_paths(tree: Mapping[str, Any], prefix: str = "") -> dict:
    """Nested dict → {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_paths(v, name))
        else:
            out[name] = v
    return out


def unflatten_paths(named: Mapping[str, Any]) -> dict:
    """{"a/b/c": leaf} → nested dict."""
    tree: dict = {}
    for name, leaf in named.items():
        node = tree
        *parents, last = name.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def tree_from_numpy(tree: Mapping[str, Any], device=None) -> dict:
    """The reference's nested dict of arrays → the port's nested dict of
    tensors on ``device``, leaf paths unchanged."""
    return unflatten_paths({name: tensor_from_numpy(leaf, device)
                            for name, leaf in flatten_paths(tree).items()})
