"""Deterministic fault injection for the serving engine (the port's own
copy of ``repro/launch/faults.py``, which is numpy-only: the same spec or
seed gives the same events in both packages).

A :class:`FaultPlan` is a seeded, step-keyed schedule of faults that the
``DecodeEngine`` consults at the top of every ``step()``. Instead of
reacting to host signals, it *manufactures* the hostile conditions
(poisoned logits, cache evictions, stale adapter handles, stalled ticks)
so every containment path can be driven deterministically in tests and
smokes.

Fault kinds
-----------
``nan``
    Overwrite the sampled logits row for ``slot`` at ``step`` with NaN on the
    host mirror (after the device fetch, before sampling).  Exercises per-row
    quarantine: the poisoned row retires with ``finish_reason="error_numeric"``
    while co-resident rows stay bitwise identical to a fault-free run.
``evict``
    Invalidate every resident entry of the engine's adapter-state cache at
    ``step``. An engine that serves one fixed adapter tree holds no cache,
    so the event does nothing there.
``stale``
    The next admission at or after ``step`` that carries an adapter handle
    is handed one whose version is behind the registry. An engine that
    serves one fixed adapter tree admits no handles, so nothing consumes
    it there.
``slow``
    Sleep ``duration_s`` (capped) at the top of ``step`` — a straggler tick
    for deadline/timeout tests.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

__all__ = ["FaultEvent", "FaultPlan", "FAULT_KINDS"]

FAULT_KINDS = ("nan", "evict", "stale", "slow")

# Safety cap on injected straggler sleeps, so a mistyped plan cannot stall
# a server or a test run.
MAX_SLOW_S = 0.25


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``step`` is the engine tick (``DecodeEngine._steps``) at which the fault
    fires.  ``slot`` targets a physical slot index for ``nan`` (``None`` means
    every active slot); it is ignored for the other kinds.  ``duration_s``
    only applies to ``slow``.
    """

    kind: str
    step: int
    slot: int | None = None
    duration_s: float = 0.05

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; want one of {FAULT_KINDS}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")


class FaultPlan:
    """An immutable, step-indexed schedule of :class:`FaultEvent`.

    Build one from explicit events, from the CLI mini-language via
    :meth:`parse` (``"nan@3:1,evict@5,stale@2,slow@4"``), or from a seed via
    :meth:`random`.  The engine consults :meth:`nan_slots` /
    :meth:`evict_at` / :meth:`stale_at` / :meth:`slow_at` once per tick.
    """

    def __init__(self, events=()):
        evs = tuple(sorted(events, key=lambda e: (e.step, FAULT_KINDS.index(e.kind), -1 if e.slot is None else e.slot)))
        self.events = evs
        by_step = defaultdict(list)
        for e in evs:
            by_step[e.step].append(e)
        self._by_step = dict(by_step)

    def __len__(self):
        return len(self.events)

    def __repr__(self):
        return f"FaultPlan({list(self.events)!r})"

    def __eq__(self, other):
        return isinstance(other, FaultPlan) and self.events == other.events

    def at(self, step):
        """All events scheduled for ``step`` (possibly empty)."""
        return tuple(self._by_step.get(step, ()))

    def nan_slots(self, step):
        """Slot indices poisoned at ``step``; ``None`` entries mean all active."""
        return tuple(e.slot for e in self.at(step) if e.kind == "nan")

    def evict_at(self, step):
        return any(e.kind == "evict" for e in self.at(step))

    def stale_at(self, step):
        return any(e.kind == "stale" for e in self.at(step))

    def slow_at(self, step):
        """Total (capped) injected sleep seconds for ``step``."""
        total = sum(e.duration_s for e in self.at(step) if e.kind == "slow")
        return min(total, MAX_SLOW_S)

    @property
    def last_step(self):
        return max((e.step for e in self.events), default=-1)

    @classmethod
    def parse(cls, spec):
        """Parse the CLI mini-language.

        ``spec`` is a comma-separated list of ``kind@step`` items; ``nan``
        accepts an optional ``:slot`` suffix (``nan@3:1`` poisons slot 1 at
        tick 3, ``nan@3`` poisons every active slot).  Whitespace is ignored.
        An empty/None spec yields an empty plan.
        """
        events = []
        for item in (spec or "").split(","):
            item = item.strip()
            if not item:
                continue
            try:
                kind, rest = item.split("@", 1)
            except ValueError:
                raise ValueError(f"bad fault item {item!r}: want kind@step[:slot]") from None
            kind = kind.strip()
            slot = None
            if ":" in rest:
                step_s, slot_s = rest.split(":", 1)
                slot = int(slot_s)
            else:
                step_s = rest
            events.append(FaultEvent(kind=kind, step=int(step_s), slot=slot))
        return cls(events)

    @classmethod
    def random(cls, seed, *, steps, slots, n_nan=1, n_evict=0, n_stale=0, n_slow=0):
        """A seeded random plan over ``steps`` ticks and ``slots`` slots.

        Deterministic: the same arguments always yield the same plan (used by
        the hypothesis property tests to pair a faulty run with its oracle).
        """
        rng = np.random.default_rng(seed)
        events = []
        for _ in range(n_nan):
            events.append(
                FaultEvent("nan", step=int(rng.integers(0, steps)), slot=int(rng.integers(0, slots)))
            )
        for _ in range(n_evict):
            events.append(FaultEvent("evict", step=int(rng.integers(0, steps))))
        for _ in range(n_stale):
            events.append(FaultEvent("stale", step=int(rng.integers(0, steps))))
        for _ in range(n_slow):
            events.append(
                FaultEvent("slow", step=int(rng.integers(0, steps)), duration_s=float(rng.uniform(0.001, 0.01)))
            )
        return cls(events)
