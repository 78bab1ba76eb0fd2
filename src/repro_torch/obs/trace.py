"""Bounded ring-buffer trace recorder for request-lifecycle events
(counterpart of ``repro/obs/trace.py``: the same taxonomy, ring and
exporters).

The recorder is the host half of the engine's observability contract:
:class:`repro_torch.launch.engine.DecodeEngine` emits one :class:`TraceEvent`
per lifecycle transition (``submitted → queued → admitted →
chunk_prefill* → first_token → token* → {preempted, resumed}* →
terminal``) plus fault/ladder events (``fault``, ``quarantined``,
``spec_disabled``, ``spec_reenabled``, ``busy_rejected``, ``spill``,
``reload``), each stamped with the engine tick AND a monotonic wall
time (:func:`monotonic` = ``time.perf_counter`` — never ``time.time``,
which can step backwards under NTP).

The hard contract — observability is FREE and INVARIANT — lives in the
emit path: :meth:`TraceRecorder.emit` only ever receives host ints the
scheduler already maintains (slot indices, tick counters, token ids the
sampler has already fetched). It performs zero device fetches, so
tracing on vs. off leaves token streams equal and ``stats()``,
``device_steps()`` and ``step_signatures()`` unchanged (asserted by
tests/test_torch_obs.py).

Storage is a bounded ring: past ``capacity`` events the OLDEST are
dropped and counted in :attr:`TraceRecorder.dropped` — a long-running
server never grows without bound, and the overflow is accounted, never
silent.

Exports: :meth:`TraceRecorder.to_jsonl` (one event per line, stable key
order) and :meth:`TraceRecorder.to_chrome_trace` (Chrome ``trace_event``
JSON — slots as tracks, requests as spans, token/fault instants —
loadable in Perfetto or ``chrome://tracing``).
"""
from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Any, Iterator

#: Monotonic wall-clock for latency deltas. ``time.perf_counter`` is
#: guaranteed monotone (``time.time`` is not: NTP steps can send it
#: backwards, producing negative "durations").
monotonic = time.perf_counter

# Lifecycle event names, in legal emission order for one request.
# ``terminal`` carries ``reason=<one of engine FINISH_REASONS>`` — the
# event taxonomy mirrors the finish-reason taxonomy.
LIFECYCLE_EVENTS = ("submitted", "queued", "admitted", "chunk_prefill",
                    "first_token", "token", "preempted", "resumed",
                    "terminal")
# Out-of-band events: faults, degradation-ladder transitions, cache tier
# traffic. ``fault`` carries ``kind=<nan|evict|stale|slow>``.
AUX_EVENTS = ("fault", "quarantined", "spec_disabled", "spec_reenabled",
              "busy_rejected", "spill", "reload")
EVENT_NAMES = LIFECYCLE_EVENTS + AUX_EVENTS


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One structured lifecycle event.

    ``tick`` is the engine step counter at emission (deterministic —
    the gateable time domain); ``t_wall`` is :func:`monotonic` seconds
    (informational — varies run to run). ``request_id``/``slot`` are
    ``None`` for events not attached to a request / a slot.
    """
    name: str
    tick: int
    t_wall: float
    request_id: int | None = None
    slot: int | None = None
    data: dict[str, Any] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        d = {"name": self.name, "tick": self.tick, "t_wall": self.t_wall,
             "request_id": self.request_id, "slot": self.slot}
        if self.data:
            d["data"] = dict(self.data)
        return d


class TraceRecorder:
    """Bounded ring buffer of :class:`TraceEvent`.

    ``capacity`` bounds resident events; overflow drops the OLDEST and
    increments :attr:`dropped`. ``clock`` is injectable for tests (must
    be monotone); it defaults to :func:`monotonic`.
    """

    def __init__(self, capacity: int = 65536, *, clock=None):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} < 1")
        self.capacity = int(capacity)
        self._clock = clock or monotonic
        self._events: deque[TraceEvent] = deque(maxlen=self.capacity)
        self._emitted = 0
        self.t0 = self._clock()

    # -- recording ----------------------------------------------------------

    def emit(self, name: str, *, tick: int, request_id: int | None = None,
             slot: int | None = None, **data: Any) -> TraceEvent:
        """Append one event. Every argument is a host scalar the caller
        already holds — this method must never trigger a device fetch."""
        ev = TraceEvent(name=name, tick=int(tick),
                        t_wall=self._clock() - self.t0,
                        request_id=request_id, slot=slot, data=data)
        self._events.append(ev)
        self._emitted += 1
        return ev

    # -- accounting ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self._events)

    def __iter__(self) -> Iterator[TraceEvent]:
        return iter(self._events)

    @property
    def emitted(self) -> int:
        """Total events ever emitted (resident + dropped)."""
        return self._emitted

    @property
    def dropped(self) -> int:
        """Events lost to ring overflow (oldest-first)."""
        return self._emitted - len(self._events)

    def events(self, name: str | None = None,
               request_id: int | None = None) -> list[TraceEvent]:
        """Resident events, optionally filtered by name and/or request."""
        return [e for e in self._events
                if (name is None or e.name == name)
                and (request_id is None or e.request_id == request_id)]

    def request_ids(self) -> list[int]:
        """Distinct request ids seen in resident events, sorted."""
        return sorted({e.request_id for e in self._events
                       if e.request_id is not None})

    # -- exporters ----------------------------------------------------------

    def to_jsonl(self, path: str | None = None) -> str:
        """One JSON object per line, oldest first. Returns the text;
        also writes it when ``path`` is given."""
        text = "\n".join(json.dumps(e.as_dict(), sort_keys=True)
                         for e in self._events)
        if text:
            text += "\n"
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def to_chrome_trace(self, path: str | None = None) -> dict:
        """Chrome ``trace_event`` JSON (Perfetto-loadable).

        Layout: pid 0 = the engine. Each SLOT is a track (tid = slot
        index) carrying one complete-event ("X") span per residency of
        a request on that slot (admitted/resumed → terminal/preempted),
        with token / chunk_prefill / first_token instants on the same
        track. The QUEUE is its own track carrying submitted→admitted
        wait spans. Fault/ladder events are instants on an "engine"
        track. Timestamps are ``t_wall`` microseconds.
        """
        evs = list(self._events)
        slots = sorted({e.slot for e in evs if e.slot is not None})
        queue_tid = (max(slots) + 1) if slots else 0
        engine_tid = queue_tid + 1
        us = 1e6

        out: list[dict] = [
            {"ph": "M", "pid": 0, "name": "process_name",
             "args": {"name": "repro_torch.launch.engine"}},
            {"ph": "M", "pid": 0, "tid": queue_tid, "name": "thread_name",
             "args": {"name": "queue"}},
            {"ph": "M", "pid": 0, "tid": engine_tid, "name": "thread_name",
             "args": {"name": "engine"}},
        ]
        for s in slots:
            out.append({"ph": "M", "pid": 0, "tid": s,
                        "name": "thread_name",
                        "args": {"name": f"slot {s}"}})

        # Per-request state for span assembly.
        submitted: dict[int, TraceEvent] = {}
        seated: dict[int, TraceEvent] = {}     # admitted/resumed event
        for e in evs:
            rid = e.request_id
            args = {"tick": e.tick, **e.data}
            if rid is not None:
                args["request_id"] = rid
            if e.name == "submitted" and rid is not None:
                submitted[rid] = e
            elif e.name in ("admitted", "resumed") and rid is not None:
                if rid in submitted:        # queue-wait span closes
                    sub = submitted.pop(rid)
                    out.append({"ph": "X", "pid": 0, "tid": queue_tid,
                                "name": f"queued r{rid}",
                                "ts": sub.t_wall * us,
                                "dur": max(e.t_wall - sub.t_wall, 0.0) * us,
                                "args": {"request_id": rid,
                                         "ticks": e.tick - sub.tick}})
                seated[rid] = e
            elif e.name in ("terminal", "preempted") and rid is not None \
                    and rid in seated:
                seat = seated.pop(rid)
                tid = seat.slot if seat.slot is not None else engine_tid
                out.append({"ph": "X", "pid": 0, "tid": tid,
                            "name": f"r{rid}",
                            "ts": seat.t_wall * us,
                            "dur": max(e.t_wall - seat.t_wall, 0.0) * us,
                            "args": args})
                if e.name == "preempted":
                    submitted[rid] = e      # back to the queue track
            if e.name in ("token", "first_token", "chunk_prefill",
                          "fault", "quarantined", "spec_disabled",
                          "spec_reenabled", "busy_rejected", "spill",
                          "reload"):
                tid = (e.slot if e.slot is not None else engine_tid)
                out.append({"ph": "i", "pid": 0, "tid": tid,
                            "name": e.name, "ts": e.t_wall * us,
                            "s": "t", "args": args})
        # Requests still resident at export time: open spans closed at
        # the last event's timestamp so the timeline stays well-formed.
        t_end = evs[-1].t_wall * us if evs else 0.0
        for rid, seat in seated.items():
            tid = seat.slot if seat.slot is not None else engine_tid
            out.append({"ph": "X", "pid": 0, "tid": tid,
                        "name": f"r{rid} (open)", "ts": seat.t_wall * us,
                        "dur": max(t_end - seat.t_wall * us, 0.0),
                        "args": {"request_id": rid, "open": True}})

        doc = {"traceEvents": out, "displayTimeUnit": "ms",
               "otherData": {"emitted": self._emitted,
                             "dropped": self.dropped}}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc
