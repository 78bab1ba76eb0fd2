"""Nested-dict trees of tensors, named by "/"-joined key paths.

The port's parameter, adapter and optimizer trees are plain dicts that
mirror the reference's pytrees, and a leaf's name is the "/"-joined path
the reference's checkpoints write (``repro/checkpoint/store.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Mapping


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


def tree_map(fn: Callable, tree: Mapping[str, Any], *rest) -> dict:
    """``fn`` over the leaves of ``tree`` (and the same leaves of the trees
    in ``rest``), structure kept."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
