"""Fault-tolerance hooks of the training loop: the port's copy of
``PreemptionHandler`` and ``Heartbeat`` from ``repro/checkpoint/fault.py``.

  - **PreemptionHandler**: converts SIGTERM (the cloud preemption signal)
    into a checked flag; the train loop polls it each step and triggers an
    immediate checkpoint + clean exit instead of dying mid-step.
  - **Heartbeat**: each host touches ``<dir>/host_<i>`` with its step and
    wall time every step. Cheap (one small atomic file write).

The reference's launcher-side ``StragglerMonitor`` (the reader of the
heartbeat files) is not ported yet.
"""
from __future__ import annotations

import json
import os
import signal
import tempfile
import time


class PreemptionHandler:
    """Installs a SIGTERM/SIGINT handler that only sets a flag.

    Both signals are handled by default: SIGTERM is the cloud preemption
    notice, and an operator's Ctrl-C (SIGINT) must take the same
    checkpoint-then-exit path rather than raising KeyboardInterrupt
    mid-step. Pass ``signals=(signal.SIGTERM,)`` to leave SIGINT alone."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._requested = False
        self._prev = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        return False

    def _handler(self, signum, frame):
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested


def _atomic_write_json(path: str, obj) -> None:
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d)
    with os.fdopen(fd, "w") as f:
        json.dump(obj, f)
    os.rename(tmp, path)


class Heartbeat:
    """Per-host liveness/progress file.

    Deliberately stamps EPOCH time (``time.time()``), not a monotonic
    clock: the heartbeat is read by OTHER processes (a straggler monitor
    on the launcher), and monotonic clocks are not comparable across
    process boundaries.
    """

    def __init__(self, directory: str, process_index: int):
        self.path = os.path.join(directory, f"host_{process_index:05d}.json")
        os.makedirs(directory, exist_ok=True)

    def beat(self, step: int) -> None:
        _atomic_write_json(self.path, {"step": step, "time": time.time()})
