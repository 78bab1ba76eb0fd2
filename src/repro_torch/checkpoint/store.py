"""Atomic, shard-per-host checkpointing for adapter + optimizer state:
the port's counterpart of ``repro/checkpoint/store.py``, with the same
layout, protocol and leaf names, so each package restores the other's
checkpoints.

Layout (per checkpoint step N):

    <dir>/step_<N>/shard_<host>.npz     flattened pytree leaves
    <dir>/step_<N>/MANIFEST.json       step, tree paths, shapes, dtypes,
                                       per-shard sha256, mesh metadata
    <dir>/LATEST                       text file: last *committed* step

Write protocol (crash-safe): write shards into ``step_<N>.tmp/``, fsync,
write MANIFEST last, atomic-rename the directory, then update LATEST (also
via tmp+rename). A reader never observes a partial checkpoint: if the
rename didn't happen the step directory doesn't exist; if LATEST wasn't
updated the previous step is used.

Elastic resize: adapter + optimizer state is DP-replicated (adapters are
small), so a checkpoint taken on any (pod x data) mesh restores onto any
other mesh whose model axis splits the same way — the manifest records the
model-axis size and ``restore_checkpoint`` verifies only that. This is the
"elastic DP" posture from DESIGN.md §5.

Only *adapter* and *optimizer* state is checkpointed — the frozen base
weights are content-addressed by config and never written (at 30B+ params
that is the difference between a 100 MB and a 60 GB checkpoint).

Leaves are tensors, named by their "/"-joined key paths
(:func:`repro_torch.tree.flatten_paths`). bf16 leaves are written as the
raw 2-byte values numpy stores for the reference's ``bfloat16`` arrays
(dtype ``V2``; the manifest says ``bfloat16``), carried through a uint16
view both ways, so no ``ml_dtypes`` is needed here.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.tree import flatten_paths, unflatten_paths


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    every_steps: int = 100
    keep: int = 3


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(array to write, manifest dtype name)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    arr = np.require(arr, requirements="C")
    if like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 \
            and arr.dtype.kind in "Vu":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr).to(like.dtype)
    return t.to(like.device)


def _flatten_with_names(tree):
    return {name: _to_numpy(leaf)
            for name, leaf in sorted(flatten_paths(tree).items())}


def _unflatten_like(tree_like, named):
    leaves = {}
    for name, like in flatten_paths(tree_like).items():
        if name not in named:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = named[name]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(
                f"checkpoint leaf {name!r} shape {arr.shape} != expected "
                f"{tuple(like.shape)} (elastic resize only re-partitions "
                f"the data axis; model-axis/param shapes must match)")
        leaves[name] = _from_numpy(arr, like)
    return unflatten_paths(leaves)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save_checkpoint(cfg: CheckpointConfig, step: int, state: dict, *,
                    process_index: int = 0, process_count: int = 1,
                    mesh_meta: dict | None = None) -> str:
    """Atomically persist ``state`` (a nested dict of tensors) for
    ``step``.

    Multi-host: every host writes its own shard_<i>.npz (here the state is
    DP-replicated so shards are identical — the shard structure is what a
    sharded-state variant plugs into); host 0 writes the manifest and
    commits LATEST.
    """
    os.makedirs(cfg.directory, exist_ok=True)
    final_dir = os.path.join(cfg.directory, f"step_{step:08d}")
    tmp_dir = final_dir + ".tmp"
    if process_index == 0:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        os.makedirs(tmp_dir, exist_ok=True)

    named = _flatten_with_names(state)
    shard_path = os.path.join(tmp_dir, f"shard_{process_index:05d}.npz")
    with open(shard_path, "wb") as f:
        np.savez(f, **{k: arr for k, (arr, _) in named.items()})
        f.flush()
        os.fsync(f.fileno())

    if process_index == 0:
        manifest = {
            "step": step,
            "process_count": process_count,
            "leaves": {k: {"shape": list(arr.shape), "dtype": dt}
                       for k, (arr, dt) in named.items()},
            "shards": {os.path.basename(shard_path): _sha256(shard_path)},
            "mesh": mesh_meta or {},
        }
        man_path = os.path.join(tmp_dir, "MANIFEST.json")
        with open(man_path, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        # Commit: atomic rename, then LATEST via tmp+rename.
        shutil.rmtree(final_dir, ignore_errors=True)
        os.rename(tmp_dir, final_dir)
        fd, tmp_latest = tempfile.mkstemp(dir=cfg.directory)
        with os.fdopen(fd, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp_latest, os.path.join(cfg.directory, "LATEST"))
        garbage_collect(cfg)
    return final_dir


def latest_step(cfg: CheckpointConfig) -> int | None:
    path = os.path.join(cfg.directory, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        step = int(f.read().strip())
    if not os.path.isdir(os.path.join(cfg.directory, f"step_{step:08d}")):
        return None  # LATEST committed but dir vanished: treat as none
    return step


def restore_checkpoint(cfg: CheckpointConfig, state_like: dict,
                       step: int | None = None, *,
                       process_index: int = 0,
                       expect_model_axis: int | None = None):
    """Restore into the structure of ``state_like`` (each leaf takes the
    dtype and device of its counterpart there). Returns (state, step) or
    (None, None) when no checkpoint exists (cold start)."""
    if step is None:
        step = latest_step(cfg)
        if step is None:
            return None, None
    d = os.path.join(cfg.directory, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    if expect_model_axis is not None:
        saved = manifest.get("mesh", {}).get("model")
        if saved is not None and saved != expect_model_axis:
            raise ValueError(
                f"checkpoint was taken with model axis {saved}, cannot "
                f"restore onto model axis {expect_model_axis} (elastic "
                f"resize covers the data/pod axes only)")
    # DP-replicated state: any shard restores any host. Prefer our own.
    shard = os.path.join(d, f"shard_{process_index:05d}.npz")
    if not os.path.exists(shard):
        shards = sorted(p for p in os.listdir(d) if p.startswith("shard_"))
        shard = os.path.join(d, shards[0])
    base = os.path.basename(shard)
    want = manifest.get("shards", {}).get(base)
    if want is not None:
        got = _sha256(shard)
        if got != want:
            raise IOError(f"checkpoint shard {base} hash mismatch "
                          f"({got[:12]} != {want[:12]}): corrupt shard")
    with np.load(shard) as z:
        named = {k: z[k] for k in z.files}
    return _unflatten_like(state_like, named), step


def garbage_collect(cfg: CheckpointConfig) -> list[str]:
    """Keep the newest ``cfg.keep`` committed checkpoints; delete older."""
    if not os.path.isdir(cfg.directory):
        return []
    steps = sorted(
        p for p in os.listdir(cfg.directory)
        if p.startswith("step_") and not p.endswith(".tmp"))
    doomed = steps[:-cfg.keep] if cfg.keep > 0 else []
    removed = []
    for p in doomed:
        shutil.rmtree(os.path.join(cfg.directory, p), ignore_errors=True)
        removed.append(p)
    return removed
