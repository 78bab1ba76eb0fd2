"""Device meshes over ``torch.distributed`` ranks (counterpart of
``repro/launch/mesh.py`` and ``repro/compat/mesh.py:28 make_mesh``).

A :class:`Mesh` lays the world's ranks out row-major over named axes,
the last axis innermost, as ``jax.make_mesh`` lays out devices: on the
production layout ``model`` is innermost, ``data`` spans the rest and
``pod`` is outermost. It carries ``axis_names`` and ``shape`` (a dict,
the duck type the sharding rules of :mod:`repro_torch.launch.sharding`
read), this rank's coordinates, and one process group per set of axes
that has more than one rank.

The caller starts ``torch.distributed`` itself
(``init_process_group(backend, init_method=..., world_size=...,
rank=...)``): nothing on a machine names a cluster. ``backend=None``
means NCCL with one card per rank. NCCL refuses two ranks on one card,
so under NCCL the ranks' (host, card) pairs are gathered and a mesh in
which two ranks share one is refused with a message that names
``backend="gloo"``; nothing switches backend or device on its own. Every collective of the port is built from
``all_reduce`` (:mod:`repro_torch.core.sharding`), which gloo runs on
CUDA tensors too, so one program runs under gloo on CPU ranks, under
gloo on ranks that share a card, and under NCCL across cards.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import socket
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a mesh of ``torch.distributed`` ranks."""
    axis_names: tuple[str, ...]
    shape: dict                   # axis name -> size
    rank: int
    coords: dict                  # axis name -> this rank's index
    device: torch.device
    backend: str | None           # None: one rank, no process group
    groups: dict = dataclasses.field(repr=False)   # axes tuple -> group

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def _axes(self, axes) -> tuple[str, ...]:
        if axes is None:
            return ()
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"mesh {self.shape} has no axis {a!r}")
        return axes

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes``, row-major in the order given
        (a PartitionSpec entry ``("pod", "data")`` has ``pod`` major)."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        """The process group of the ranks that differ from this one only
        along ``axes``; None when it holds this rank alone."""
        key = tuple(a for a in self.axis_names
                    if a in self._axes(axes) and self.shape[a] > 1)
        if not key:
            return None
        return self.groups[key]


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: device=None means the card, and torch sees no "
                "CUDA device; pass device='cpu' to run the ranks on the "
                "CPU (with backend='gloo')")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def check_backend(backend: str, device: torch.device,
                  placements=None) -> None:
    """Refuse a backend that cannot run the mesh's ranks on ``device``.
    ``placements``: one ``(host, card index)`` per rank, in rank order;
    under NCCL no two ranks may name the same card of the same host."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: want 'nccl' or 'gloo'")
    if backend != "nccl":
        return
    if device.type != "cuda":
        raise ValueError(
            f"backend='nccl' reduces CUDA tensors only, and the mesh runs "
            f"on {device}: pass backend='gloo'")
    first: dict = {}
    for rank, (host, card) in enumerate(placements or ()):
        if (host, card) in first:
            raise ValueError(
                f"ranks {first[host, card]} and {rank} would share card "
                f"{card} of host {host!r}, which NCCL refuses: give each "
                f"rank its own card (torch.cuda.set_device(local_rank) "
                f"before make_mesh, or device=), or pass backend='gloo' "
                f"(its collectives are staged through the host)")
        first[host, card] = rank


def _placements(device: torch.device) -> list:
    """Every rank's ``(host, card index)``, gathered over a gloo group of
    the whole world: it runs where NCCL would refuse the ranks' layout,
    so the refusal is a message and not a hang."""
    card = device.index
    if card is None:                  # "cuda" means the current card
        card = torch.cuda.current_device()
    out: list = [None] * dist.get_world_size()
    dist.all_gather_object(out, (socket.gethostname(), card),
                           group=dist.new_group(backend="gloo"))
    return out


def make_mesh(axis_shapes, axis_names, *, device=None,
              backend: str | None = None) -> Mesh:
    """A mesh of ``prod(axis_shapes)`` ranks named ``axis_names``, on the
    process group the caller started. ``device=None`` means the card
    (refused when there is none); ``backend=None`` means NCCL. A mesh of
    one rank needs no process group."""
    shape = tuple(int(s) for s in axis_shapes)
    names = tuple(axis_names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} do not "
                         f"pair up")
    dev = _resolve_device(device)
    backend = "nccl" if backend is None else backend
    world = math.prod(shape)
    check_backend(backend, dev)
    sizes = dict(zip(names, shape))
    if world == 1 and not dist.is_initialized():
        return Mesh(names, sizes, 0, {a: 0 for a in names}, dev, None, {})
    if not dist.is_initialized():
        raise RuntimeError(
            f"make_mesh: a mesh of {world} ranks needs torch.distributed: "
            f"call init_process_group({backend!r}, init_method=..., "
            f"world_size={world}, rank=...) first")
    if dist.get_world_size() != world:
        raise ValueError(f"mesh {sizes} has {world} ranks, the process "
                         f"group {dist.get_world_size()}")
    started = dist.get_backend()
    if started != backend:
        raise ValueError(
            f"the process group runs {started!r} but the mesh asks for "
            f"{backend!r}: pass backend={started!r} or restart the group")
    if backend == "nccl":
        check_backend(backend, dev, _placements(dev))
    rank = dist.get_rank()
    coords, rest = {}, rank
    for a, s in reversed(list(zip(names, shape))):
        coords[a] = rest % s
        rest //= s
    coords = {a: coords[a] for a in names}
    groups: dict[tuple, Any] = {}
    # Every rank creates every group in the same order (new_group is
    # collective), and keeps the ones that hold it.
    for n in range(1, len(names) + 1):
        for axes in itertools.combinations(names, n):
            if math.prod(sizes[a] for a in axes) == 1:
                continue
            others = [a for a in names if a not in axes]
            for fixed in itertools.product(*(range(sizes[a])
                                              for a in others)):
                at = dict(zip(others, fixed))
                ranks = []
                for inner in itertools.product(*(range(sizes[a])
                                                 for a in axes)):
                    c = {**at, **dict(zip(axes, inner))}
                    r = 0
                    for a in names:
                        r = r * sizes[a] + c[a]
                    ranks.append(r)
                g = dist.new_group(sorted(ranks), backend=backend)
                if rank in ranks:
                    groups[axes] = g
    return Mesh(names, sizes, rank, coords, dev, backend, groups)


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         backend: str | None = None) -> Mesh:
    """The reference's layout over the started world: ``model`` innermost
    (16 ranks, or the largest power of two under 16 that divides the
    ranks of a pod), ``data`` over the rest of a pod, and with
    ``multi_pod`` two pods outermost."""
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh takes its world size "
                           "from torch.distributed: start it first")
    world = dist.get_world_size()
    pods = 2 if multi_pod else 1
    if world % pods:
        raise ValueError(f"{world} ranks do not split into {pods} pods")
    per_pod = world // pods
    model = 16
    while per_pod % model:
        model //= 2
    shape = (per_pod // model, model)
    names = ("data", "model")
    if multi_pod:
        shape, names = (pods,) + shape, ("pod",) + names
    return make_mesh(shape, names, device=device, backend=backend)


def make_debug_mesh(data: int = 1, model: int = 1, *, device=None,
                    backend: str | None = None) -> Mesh:
    """A small (data, model) mesh for tests and the chip smoke."""
    return make_mesh((data, model), ("data", "model"), device=device,
                     backend=backend)


def data_axes(mesh) -> tuple[str, ...]:
    """The batch/FSDP axes present in this mesh ((pod, data) or (data,))."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, *names) -> int:
    s = 1
    for n in names:
        if n in mesh.axis_names:
            s *= mesh.shape[n]
    return s
