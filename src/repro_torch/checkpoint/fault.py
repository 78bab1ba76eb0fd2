"""Fault-tolerance hooks of the training loop: the port's copy of
``PreemptionHandler``, ``Heartbeat`` and ``StragglerMonitor`` from
``repro/checkpoint/fault.py``.

  - **PreemptionHandler**: converts SIGTERM (the cloud preemption signal)
    into a checked flag; the train loop polls it each step and triggers an
    immediate checkpoint + clean exit instead of dying mid-step.
  - **Heartbeat**: each host touches ``<dir>/host_<i>`` with its step and
    wall time every step. Cheap (one small atomic file write).
  - **StragglerMonitor**: the launcher-side reader of those files: a host
    is flagged when its beat is older than ``dead_after_s`` or its step
    trails the median by more than ``step_slack``.
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


class StragglerMonitor:
    """Launcher-side detector over the heartbeat directory."""

    def __init__(self, directory: str, *, step_slack: int = 5,
                 dead_after_s: float = 300.0):
        self.directory = directory
        self.step_slack = step_slack
        self.dead_after_s = dead_after_s

    def read(self) -> dict[str, dict]:
        out = {}
        if not os.path.isdir(self.directory):
            return out
        for name in sorted(os.listdir(self.directory)):
            if not name.startswith("host_"):
                continue
            try:
                with open(os.path.join(self.directory, name)) as f:
                    out[name] = json.load(f)
            except (json.JSONDecodeError, OSError):
                # A torn read of a beat in flight: stale, not fatal.
                out[name] = {"step": -1, "time": 0.0}
        return out

    def stragglers(self, now: float | None = None) -> list[str]:
        beats = self.read()
        if not beats:
            return []
        now = time.time() if now is None else now
        steps = sorted(b["step"] for b in beats.values())
        median = steps[len(steps) // 2]
        flagged = []
        for name, b in beats.items():
            if now - b["time"] > self.dead_after_s:
                flagged.append(name)
            elif median - b["step"] > self.step_slack:
                flagged.append(name)
        return flagged

    def healthy(self, expected_hosts: int, now: float | None = None) -> bool:
        beats = self.read()
        return len(beats) == expected_hosts and not self.stragglers(now)
