"""Multi-tenant adapter-state cache (counterpart of
``repro/core/adapter_cache.py``): an LRU of precomputed serving states.

The frozen-adapter serving state (:func:`repro_torch.core.adapter.
precompute_adapter_state`) makes decode do no factored-norm work per
token, but it is computed for ONE adapter set. A multi-tenant server swaps
adapter sets per request, so this module keeps an LRU of precomputed
states keyed by :class:`AdapterKey` (adapter id, version, activation
dtype, gsB folding, sharding fingerprint) with byte accounting
(``max_bytes`` eviction over the full state trees) and hit/miss/evict
counters in a :class:`CacheStats`.

Why those key fields: the rsLoRA scaling ``s`` is folded into both the
norm and ``gsB`` and rides in through the precompute function's
``DoRAConfig``, so one cache is bound to one config; the activation dtype
picks the ``eps`` the cached ``g`` was computed with; the sharding
fingerprint (:func:`mesh_fingerprint`) names the mesh the leaves were
computed and laid out for, ``None`` on one card.

Versioning composes with the training contract: ``register``/``update``
strip any serving leaves (:func:`invalidate_adapter_state`), so the
registry always holds the raw trainable tree; ``update`` bumps the
version and drops every cached state of older versions; and a request
carrying a stale :class:`AdapterHandle` is always refused with an error
naming the key fields, so a caller that swaps adapters without
re-precomputing can never serve the wrong weights.

Byte accounting counts every leaf of a state, as the reference does (its
jitted precompute returns fresh A/B/m buffers). Under a mesh each rank
keeps its own cache of its own shards, so the bytes it counts and its
``max_bytes`` are this rank's. The port's precompute
returns a tree whose A/B/m are the registry's own tensors, so a state
adds only its ``g``/``gsB`` to what the card holds, and a spill to the
host tier frees only those while the registry holds A/B/m.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Any, Callable

import torch

from repro_torch.core.adapter import invalidate_adapter_state
from repro_torch.tree import tree_map

@dataclasses.dataclass(frozen=True)
class AdapterHandle:
    """What a request carries: which adapter set, at which version."""
    adapter_id: str
    version: int


@dataclasses.dataclass(frozen=True)
class AdapterKey:
    """Full LRU key for one precomputed serving state."""
    adapter_id: str
    version: int
    act_dtype: str
    fold_gsb: bool
    sharding: Any = None          # hashable layout fingerprint or None

    def describe(self) -> str:
        return (f"adapter_id={self.adapter_id!r} version={self.version} "
                f"act_dtype={self.act_dtype} fold_gsb={self.fold_gsb} "
                f"sharding={self.sharding}")


@dataclasses.dataclass(frozen=True)
class CacheStats:
    """Point-in-time counters (returned by :meth:`AdapterStateCache.stats`;
    the cache keeps mutating its own tallies)."""
    hits: int
    misses: int
    evictions: int
    invalidations: int
    entries: int
    current_bytes: int
    max_bytes: int | None
    thrashing: bool = False    # every recent lookup was an evicting miss
    # -- host spill tier (all zero without host_max_bytes) ------------------
    host_entries: int = 0      # states resident in the host tier
    host_bytes: int = 0        # bytes the host tier holds
    host_max_bytes: int | None = None
    spills: int = 0            # device evictions preserved to host
    reloads: int = 0           # host states promoted back to device
    host_drops: int = 0        # states dropped from the host tier (true loss)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class AdapterCacheMiss(LookupError):
    """A request's adapter state is not servable from the cache. ``key``
    carries the full :class:`AdapterKey`; the message names every field."""

    def __init__(self, message: str, key: AdapterKey):
        super().__init__(message)
        self.key = key


def mesh_fingerprint(mesh) -> tuple | None:
    """Hashable identity of a mesh's layout (axis names x sizes), enough
    to tell apart states laid out for different meshes; None for no
    mesh."""
    if mesh is None:
        return None
    shape = dict(mesh.shape)
    return tuple((a, shape[a]) for a in mesh.axis_names)


def _tree_to_host(tree):
    """Move a state tree to host memory: (host tree, devices tree). Each
    leaf's device is kept so a reload puts it back where it was."""
    return (tree_map(lambda t: t.to("cpu"), tree),
            tree_map(lambda t: t.device, tree))


def _tree_to_device(host_tree, dev_tree):
    """Inverse of :func:`_tree_to_host`: bitwise the original state (a
    copy between devices never rewrites bits)."""
    return tree_map(lambda t, d: t.to(d), host_tree, dev_tree)


def serving_state_nbytes(tree) -> int:
    """Bytes a cached serving tree counts: every tensor leaf, raw adapter
    weights included (the reference's count, whose precompute returns
    fresh A/B/m; see the module note for what the port's card holds)."""
    total = 0
    if isinstance(tree, dict):
        for v in tree.values():
            if isinstance(v, dict):
                total += serving_state_nbytes(v)
            elif isinstance(v, torch.Tensor):
                total += v.numel() * v.element_size()
    return total


class AdapterStateCache:
    """LRU of precomputed per-tenant serving states with byte accounting.

    ``precompute(params, raw_adapters) -> serving tree`` builds a state:
    :func:`repro_torch.launch.steps.make_precompute_step` for model-level
    trees (see :meth:`for_serving`), or a thin ``precompute_adapter_state``
    wrapper in unit tests.

    ``max_bytes`` bounds the bytes of the cached state trees (every leaf,
    :func:`serving_state_nbytes`); the least recently used states are
    evicted past it. Under a mesh the trees are one rank's shards, so the
    bytes counted and the bound are that rank's. A single state larger
    than the whole budget is kept (serving must proceed) and everything
    else is evicted around it.

    ``host_max_bytes`` adds a host-memory spill tier under the device LRU.
    Device eviction then SPILLS the state to the host (``.to("cpu")``,
    each leaf's device kept) instead of dropping it; a later lookup
    RELOADS it (``.to(device)`` back, bitwise the original precompute, at
    host-copy cost instead of a precompute); only host-tier overflow drops
    a state (``host_drops``). A spilled state never raises
    :class:`AdapterCacheMiss` under warm-only routing
    (``allow_miss=False``), and a reload is not an evicting miss for
    :meth:`thrashing`. Every state is resident in exactly one tier;
    version bumps and :meth:`invalidate` clear both.
    """

    def __init__(self, precompute: Callable[[Any, Any], Any], *,
                 max_bytes: int | None = None,
                 host_max_bytes: int | None = None,
                 act_dtype: Any = torch.float32,
                 fold_gsb: bool = True,
                 sharding: Any = None,
                 thrash_window: int = 4):
        self._precompute = precompute
        self.max_bytes = max_bytes
        self.host_max_bytes = host_max_bytes
        # "float32" for torch.float32: the reference's numpy dtype name.
        self.act_dtype = str(act_dtype).removeprefix("torch.")
        self.fold_gsb = bool(fold_gsb)
        self.sharding = sharding
        if thrash_window < 1:
            raise ValueError(f"thrash_window={thrash_window} < 1")
        self.thrash_window = int(thrash_window)
        self._registry: dict[str, tuple[int, Any]] = {}
        self._lru: "OrderedDict[AdapterKey, tuple[Any, int]]" = OrderedDict()
        # Host spill tier: key -> (host tree, devices tree, nbytes),
        # LRU-ordered; only populated when host_max_bytes is set.
        self._host: "OrderedDict[AdapterKey, tuple[Any, Any, int]]" = \
            OrderedDict()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._invalidations = 0
        self._current_bytes = 0
        self._host_bytes = 0
        self._spills = 0
        self._reloads = 0
        self._host_drops = 0
        # Observability hook: ``on_event(kind, key)`` fires on tier traffic
        # ("spill" / "reload"). It must stay cheap and must never raise.
        self.on_event: Callable[[str, AdapterKey], None] | None = None
        # The last `thrash_window` lookups: True iff the lookup was a miss
        # whose insertion evicted someone. All True (a full window) = the
        # working set cannot fit.
        self._recent_evicting: deque[bool] = deque(maxlen=self.thrash_window)

    # -- construction -------------------------------------------------------

    @classmethod
    def for_serving(cls, mcfg, scfg, mesh=None, *, device=None,
                    max_bytes=None, host_max_bytes=None,
                    fold_gsb: bool = True) -> "AdapterStateCache":
        """Model-level cache: precompute = ``make_precompute_step`` (K1 with
        its epilogue once per adapted module on the card), act_dtype = the
        model dtype, key fingerprint = the mesh's layout. ``device``: None
        is the card, which must be present (the mesh's device when a mesh
        is given); ``"cpu"`` is the explicit CPU request. Params handed to
        :meth:`get_state` must live there.

        ``mesh``: each rank builds its own cache over its own shards;
        registered trees and the params handed to :meth:`get_state` are
        this rank's, the precompute is the mesh's (the norm's partials of
        wo and w_down summed over ``model``), and ``max_bytes`` bounds
        this rank's bytes."""
        from repro_torch.launch.serve import resolve_device
        from repro_torch.launch.steps import make_precompute_step
        dev = resolve_device(device if device is not None or mesh is None
                             else mesh.device)
        step = make_precompute_step(mcfg, scfg, mesh, fold_gsb=fold_gsb)

        def precompute(params, adapters):
            if params["embed"].device != dev:
                raise ValueError(
                    f"params live on {params['embed'].device}, the adapter "
                    f"cache serves on {dev}")
            return step(params, adapters)

        return cls(precompute, max_bytes=max_bytes,
                   host_max_bytes=host_max_bytes, act_dtype=mcfg.dtype,
                   fold_gsb=fold_gsb, sharding=mesh_fingerprint(mesh))

    # -- registry (raw trainable trees + versions) --------------------------

    def register(self, adapter_id: str, adapters) -> AdapterHandle:
        """Register a NEW adapter set at version 0. Serving leaves are
        stripped: the registry always holds the raw trainable tree."""
        if adapter_id in self._registry:
            raise ValueError(
                f"adapter_id {adapter_id!r} is already registered "
                f"(version {self._registry[adapter_id][0]}); use "
                f"update() to publish new weights")
        self._registry[adapter_id] = (0, invalidate_adapter_state(adapters))
        return AdapterHandle(adapter_id, 0)

    def update(self, adapter_id: str, adapters) -> AdapterHandle:
        """Publish updated weights for a registered adapter set: bumps the
        version and drops every cached state of older versions."""
        if adapter_id not in self._registry:
            raise KeyError(f"adapter_id {adapter_id!r} is not registered")
        version = self._registry[adapter_id][0] + 1
        self._registry[adapter_id] = (version,
                                      invalidate_adapter_state(adapters))
        self.invalidate(adapter_id)
        return AdapterHandle(adapter_id, version)

    def current_handle(self, adapter_id: str) -> AdapterHandle:
        if adapter_id not in self._registry:
            raise KeyError(f"adapter_id {adapter_id!r} is not registered")
        return AdapterHandle(adapter_id, self._registry[adapter_id][0])

    def adapters(self, adapter_id: str):
        """The registered raw (trainable) tree at the current version."""
        return self._registry[adapter_id][1]

    # -- the LRU ------------------------------------------------------------

    def make_key(self, handle: AdapterHandle) -> AdapterKey:
        return AdapterKey(handle.adapter_id, handle.version,
                          self.act_dtype, self.fold_gsb, self.sharding)

    def get_state(self, params, handle: AdapterHandle, *,
                  allow_miss: bool = True):
        """The precomputed serving tree for ``handle``.

        A stale handle (version != the registered current version) is
        always an error. A current handle whose state is not cached is a
        miss: precomputed and inserted when ``allow_miss`` (evicting LRU
        states past ``max_bytes``), or :class:`AdapterCacheMiss` naming
        every key field when the caller asked for warm-only serving.
        """
        if handle.adapter_id not in self._registry:
            raise AdapterCacheMiss(
                f"adapter_id {handle.adapter_id!r} is not registered with "
                f"this cache (key: {self.make_key(handle).describe()}); "
                f"register(adapter_id, adapters) first",
                self.make_key(handle))
        current, raw = self._registry[handle.adapter_id]
        if handle.version != current:
            raise AdapterCacheMiss(
                f"stale adapter handle: request pinned "
                f"{self.make_key(handle).describe()} but the registered "
                f"version is {current} — the adapter was updated after "
                f"this handle was issued; re-resolve with "
                f"current_handle({handle.adapter_id!r}) (a stale state "
                f"would silently serve the wrong weights)",
                self.make_key(handle))
        key = self.make_key(handle)
        if key in self._lru:
            self._lru.move_to_end(key)
            self._hits += 1
            self._recent_evicting.append(False)
            return self._lru[key][0]
        if key in self._host:
            # Spilled but registered: back to the device tier at host-copy
            # cost. Never an AdapterCacheMiss, never a precompute, and not
            # an evicting miss for the thrash window.
            host_tree, dev_tree, nbytes = self._host.pop(key)
            self._host_bytes -= nbytes
            state = _tree_to_device(host_tree, dev_tree)
            self._reloads += 1
            if self.on_event is not None:
                self.on_event("reload", key)
            self._lru[key] = (state, nbytes)
            self._current_bytes += nbytes
            self._evict_over_budget()
            self._recent_evicting.append(False)
            return state
        if not allow_miss:
            raise AdapterCacheMiss(
                f"adapter state not precomputed and allow_miss=False: "
                f"{key.describe()} — warm the cache with "
                f"get_state(params, handle) (or precompute at publish "
                f"time) before serving with warm-only routing",
                key)
        self._misses += 1
        state = self._precompute(params, raw)
        nbytes = serving_state_nbytes(state)
        self._lru[key] = (state, nbytes)
        self._current_bytes += nbytes
        ev_before = self._evictions
        self._evict_over_budget()
        self._recent_evicting.append(self._evictions > ev_before)
        return state

    def _evict_over_budget(self) -> None:
        if self.max_bytes is None:
            return
        while self._current_bytes > self.max_bytes and len(self._lru) > 1:
            key, (state, nbytes) = self._lru.popitem(last=False)
            self._current_bytes -= nbytes
            self._evictions += 1
            if self.host_max_bytes is not None:
                # Spill instead of drop: the state moves to host memory,
                # each leaf's device kept, so a reload lands bitwise.
                host_tree, dev_tree = _tree_to_host(state)
                self._host[key] = (host_tree, dev_tree, nbytes)
                self._host_bytes += nbytes
                self._spills += 1
                if self.on_event is not None:
                    self.on_event("spill", key)
                self._shrink_host_tier()

    def _shrink_host_tier(self) -> None:
        while (self._host_bytes > self.host_max_bytes
               and len(self._host) > 1):
            _, (_, _, nbytes) = self._host.popitem(last=False)
            self._host_bytes -= nbytes
            self._host_drops += 1

    def invalidate(self, adapter_id: str | None = None) -> int:
        """Drop cached states (all of one adapter's versions, or the whole
        cache) from BOTH tiers; the registry is untouched. Returns the
        number of states dropped."""
        doomed = [k for k in self._lru
                  if adapter_id is None or k.adapter_id == adapter_id]
        for k in doomed:
            _, nbytes = self._lru.pop(k)
            self._current_bytes -= nbytes
        doomed_host = [k for k in self._host
                       if adapter_id is None or k.adapter_id == adapter_id]
        for k in doomed_host:
            _, _, nbytes = self._host.pop(k)
            self._host_bytes -= nbytes
        doomed += doomed_host
        self._invalidations += len(doomed)
        # An explicit drop is not thrash: the next lookups miss because the
        # states were removed, not because the working set outgrew the
        # budget.
        self._recent_evicting.clear()
        return len(doomed)

    def is_resident(self, handle: AdapterHandle) -> bool:
        """Whether ``handle``'s state is in the device LRU right now (no
        staleness check, no LRU-order side effects)."""
        return self.make_key(handle) in self._lru

    def is_spilled(self, handle: AdapterHandle) -> bool:
        """Whether ``handle``'s state sits in the host spill tier:
        servable at host-copy cost. Always False without a host tier."""
        return self.make_key(handle) in self._host

    def thrashing(self) -> bool:
        """True when the last ``thrash_window`` lookups were ALL evicting
        misses: the working set cannot fit ``max_bytes``."""
        return (len(self._recent_evicting) == self.thrash_window
                and all(self._recent_evicting))

    def cached_keys(self) -> tuple[AdapterKey, ...]:
        """LRU order, least recently used first (eviction order)."""
        return tuple(self._lru.keys())

    def spilled_keys(self) -> tuple[AdapterKey, ...]:
        """Host-tier keys, least recently spilled first (drop order)."""
        return tuple(self._host.keys())

    def stats(self) -> CacheStats:
        return CacheStats(hits=self._hits, misses=self._misses,
                          evictions=self._evictions,
                          invalidations=self._invalidations,
                          entries=len(self._lru),
                          current_bytes=self._current_bytes,
                          max_bytes=self.max_bytes,
                          thrashing=self.thrashing(),
                          host_entries=len(self._host),
                          host_bytes=self._host_bytes,
                          host_max_bytes=self.host_max_bytes,
                          spills=self._spills,
                          reloads=self._reloads,
                          host_drops=self._host_drops)
