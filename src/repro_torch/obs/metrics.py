"""Metrics registry: counters / gauges / fixed-bucket histograms with
Prometheus-text and JSON snapshot exporters (counterpart of
``repro/obs/metrics.py``).

Two time domains, deliberately separate:

* **ticks** — engine step counts. Deterministic for a fixed arrival
  trace, so tick-domain metrics are GATEABLE (``BENCH_serve.json``'s
  ``obs.lifecycle_model`` is held in tick percentiles).
* **seconds** — :func:`repro_torch.obs.monotonic` deltas. Informational
  only; they vary run to run and are never asserted on.

:func:`lifecycle_latencies` derives per-request latency from a
:class:`repro_torch.obs.TraceRecorder` (TTFT, inter-token latency, queue
wait, admission-to-retire — each in both domains), and
:func:`engine_metrics` assembles the full registry for a live engine:
``EngineStats`` counters, ``CacheStats`` hit/spill/reload counters,
``pool_stats()`` block-pool occupancy gauges, the device steps run under
each step signature, and the derived latency histograms. Everything read
is a host mirror — building a snapshot performs zero device fetches.

Every metric name is the reference's but one: the reference counts XLA
executables per step function in ``compiles_total{fn, sig}``, which
PyTorch does not have. The port counts the device steps the engine ran
instead, in ``device_steps_total{fn, sig}``: ``sig`` is the step
signature (``step_signatures()``) for decode and verify, and empty for
the other steps (``device_steps()``).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Iterable, Mapping

from repro_torch.obs.trace import TraceRecorder

# Fixed bucket edges. Ticks: powers of two out to one committed-trace
# horizon. Seconds: log-ish decades from 100us to 30s. Fixed (not
# adaptive) so two snapshots are always mergeable/comparable.
TICK_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
SECONDS_BUCKETS = (1e-4, 1e-3, 1e-2, 0.1, 0.5, 1.0, 5.0, 30.0)


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integers stay integral."""
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(labels: Mapping[str, str] | None) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    """Monotone counter (resets only with a new registry)."""

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment {n} < 0")
        self.value += n


class Gauge:
    """Point-in-time value."""

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram (cumulative on export, Prometheus-style).

    ``buckets`` are finite upper bounds; a ``+Inf`` bucket is implicit.
    """

    def __init__(self, buckets: Iterable[float]):
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(self.buckets) or not self.buckets:
            raise ValueError(f"bucket edges must be sorted/non-empty: "
                             f"{self.buckets}")
        self.counts = [0] * (len(self.buckets) + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> list[tuple[float, int]]:
        """(upper_bound, cumulative_count) pairs ending at +Inf."""
        out, acc = [], 0
        for edge, c in zip(self.buckets, self.counts):
            acc += c
            out.append((edge, acc))
        out.append((math.inf, acc + self.counts[-1]))
        return out


@dataclasses.dataclass
class _Family:
    kind: str                 # "counter" | "gauge" | "histogram"
    help: str
    samples: dict             # frozenset(labels.items()) -> metric object
    label_maps: dict          # same key -> original labels dict


class MetricsRegistry:
    """Named metric families with label support and two exporters."""

    def __init__(self, namespace: str = "repro"):
        self.namespace = namespace
        self._families: dict[str, _Family] = {}

    def _get(self, name: str, kind: str, help: str,
             labels: Mapping[str, str] | None, factory):
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = _Family(kind, help, {}, {})
        elif fam.kind != kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{fam.kind}, not {kind}")
        key = frozenset((labels or {}).items())
        if key not in fam.samples:
            fam.samples[key] = factory()
            fam.label_maps[key] = dict(labels or {})
        return fam.samples[key]

    def counter(self, name: str, help: str = "",
                labels: Mapping[str, str] | None = None) -> Counter:
        return self._get(name, "counter", help, labels, Counter)

    def gauge(self, name: str, help: str = "",
              labels: Mapping[str, str] | None = None) -> Gauge:
        return self._get(name, "gauge", help, labels, Gauge)

    def histogram(self, name: str, help: str = "",
                  labels: Mapping[str, str] | None = None,
                  buckets: Iterable[float] = TICK_BUCKETS) -> Histogram:
        return self._get(name, "histogram", help, labels,
                         lambda: Histogram(buckets))

    # -- exporters ----------------------------------------------------------

    def to_prometheus(self, path: str | None = None) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        lines: list[str] = []
        ns = self.namespace
        for name in sorted(self._families):
            fam = self._families[name]
            full = f"{ns}_{name}" if ns else name
            if fam.help:
                lines.append(f"# HELP {full} {fam.help}")
            lines.append(f"# TYPE {full} {fam.kind}")
            for key in sorted(fam.samples,
                              key=lambda k: sorted(fam.label_maps[k].items())):
                m = fam.samples[key]
                labels = fam.label_maps[key]
                if fam.kind == "histogram":
                    for edge, cum in m.cumulative():
                        le = dict(labels, le=_fmt(edge))
                        lines.append(
                            f"{full}_bucket{_label_str(le)} {cum}")
                    lines.append(
                        f"{full}_sum{_label_str(labels)} {_fmt(m.sum)}")
                    lines.append(
                        f"{full}_count{_label_str(labels)} {m.count}")
                else:
                    lines.append(
                        f"{full}{_label_str(labels)} {_fmt(m.value)}")
        text = "\n".join(lines) + ("\n" if lines else "")
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def to_json(self, path: str | None = None) -> dict:
        """JSON snapshot: {family: {kind, help, samples: [...]}}."""
        out: dict[str, Any] = {}
        for name in sorted(self._families):
            fam = self._families[name]
            samples = []
            for key in sorted(fam.samples,
                              key=lambda k: sorted(fam.label_maps[k].items())):
                m = fam.samples[key]
                s: dict[str, Any] = {"labels": fam.label_maps[key]}
                if fam.kind == "histogram":
                    s["sum"] = m.sum
                    s["count"] = m.count
                    s["buckets"] = [[("inf" if math.isinf(e) else e), c]
                                    for e, c in m.cumulative()]
                else:
                    s["value"] = m.value
                samples.append(s)
            out[name] = {"kind": fam.kind, "help": fam.help,
                         "samples": samples}
        if path is not None:
            with open(path, "w") as f:
                json.dump(out, f, indent=1, sort_keys=True)
        return out


def parse_prometheus(text: str) -> dict[str, float]:
    """Minimal parser for the exposition format this module writes:
    {sample_name_with_labels: value}. Used by smokes/tests to validate
    ``--metrics-out`` output round-trips."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        if not name:
            raise ValueError(f"malformed sample line: {line!r}")
        out[name] = float(value)
    return out


def percentile(values: Iterable[float], q: float) -> float:
    """Deterministic nearest-rank percentile (q in [0, 100]) — the
    tick-domain percentile the bench gates use. Returns 0.0 on empty."""
    xs = sorted(values)
    if not xs:
        return 0.0
    if not 0 <= q <= 100:
        raise ValueError(f"q={q} outside [0, 100]")
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return float(xs[rank - 1])


# ---------------------------------------------------------------------------
# Derived per-request latency from a trace
# ---------------------------------------------------------------------------

def lifecycle_latencies(rec: TraceRecorder) -> dict[int, dict]:
    """Per-request latency derived from lifecycle events, in BOTH
    domains. For each request id seen in the trace::

        {"submitted_tick", "admitted_tick", "first_token_tick",
         "terminal_tick", "reason",
         "queue_wait_ticks",        # submitted -> first admission
         "ttft_ticks",              # submitted -> first_token
         "admit_to_retire_ticks",   # first admission -> terminal
         "itl_ticks": [...],        # successive token-emission gaps
         "queue_wait_s", "ttft_s", "admit_to_retire_s", "itl_s": [...]}

    Fields are ``None`` (lists empty) when the trace lacks the events —
    e.g. a queued-timeout request never admitted. Requests whose early
    events were dropped by ring overflow report what remains.
    """
    first: dict[int, dict[str, Any]] = {}
    tokens: dict[int, list] = {}
    for e in rec:
        if e.request_id is None:
            continue
        r = first.setdefault(e.request_id, {})
        if e.name in ("submitted", "admitted", "first_token", "terminal") \
                and e.name not in r:
            r[e.name] = e
        if e.name in ("first_token", "token"):
            tokens.setdefault(e.request_id, []).append(e)

    out: dict[int, dict] = {}
    for rid in sorted(first):
        r = first[rid]
        sub, adm = r.get("submitted"), r.get("admitted")
        ft, term = r.get("first_token"), r.get("terminal")

        def delta(a, b, attr):
            if a is None or b is None:
                return None
            return getattr(b, attr) - getattr(a, attr)

        toks = tokens.get(rid, [])
        out[rid] = {
            "submitted_tick": sub.tick if sub else None,
            "admitted_tick": adm.tick if adm else None,
            "first_token_tick": ft.tick if ft else None,
            "terminal_tick": term.tick if term else None,
            "reason": (term.data.get("reason") if term else None),
            "queue_wait_ticks": delta(sub, adm, "tick"),
            "ttft_ticks": delta(sub, ft, "tick"),
            "admit_to_retire_ticks": delta(adm, term, "tick"),
            "itl_ticks": [b.tick - a.tick
                          for a, b in zip(toks, toks[1:])],
            "queue_wait_s": delta(sub, adm, "t_wall"),
            "ttft_s": delta(sub, ft, "t_wall"),
            "admit_to_retire_s": delta(adm, term, "t_wall"),
            "itl_s": [b.t_wall - a.t_wall
                      for a, b in zip(toks, toks[1:])],
        }
    return out


def latency_metrics(rec: TraceRecorder,
                    registry: MetricsRegistry | None = None
                    ) -> MetricsRegistry:
    """Fill a registry with the derived latency histograms (both
    domains) plus terminal-reason counters and trace accounting."""
    reg = registry or MetricsRegistry()
    lat = lifecycle_latencies(rec)
    hists = (("queue_wait", "queue wait, submit to first admission"),
             ("ttft", "time to first token"),
             ("itl", "inter-token latency"),
             ("admit_to_retire", "first admission to terminal"))
    for stem, help in hists:
        ht = reg.histogram(f"{stem}_ticks", f"{help} (engine ticks)",
                           buckets=TICK_BUCKETS)
        hs = reg.histogram(f"{stem}_seconds", f"{help} (monotonic s)",
                           buckets=SECONDS_BUCKETS)
        for r in lat.values():
            if stem == "itl":
                for v in r["itl_ticks"]:
                    ht.observe(v)
                for v in r["itl_s"]:
                    hs.observe(v)
            else:
                if r[f"{stem}_ticks"] is not None:
                    ht.observe(r[f"{stem}_ticks"])
                if r[f"{stem}_s"] is not None:
                    hs.observe(r[f"{stem}_s"])
    for r in lat.values():
        if r["reason"] is not None:
            reg.counter("requests_finished_total",
                        "terminal events by finish reason",
                        labels={"reason": str(r["reason"])}).inc()
    reg.counter("trace_events_emitted_total",
                "events emitted to the trace ring").inc(rec.emitted)
    reg.counter("trace_events_dropped_total",
                "events lost to ring overflow").inc(rec.dropped)
    return reg


# ---------------------------------------------------------------------------
# Engine snapshot: wrap EngineStats / CacheStats / pool_stats
# ---------------------------------------------------------------------------

def engine_metrics(engine, recorder: TraceRecorder | None = None,
                   namespace: str = "repro") -> MetricsRegistry:
    """Full metrics snapshot for a live DecodeEngine (duck-typed — no
    engine import, so obs stays leaf-level). Reads only host mirrors:
    ``stats()``, ``device_steps()``, ``step_signatures()``, the adapter
    cache's counters and ``pool_stats()`` are all plain-python state."""
    reg = MetricsRegistry(namespace)
    st = engine.stats()
    d = st.as_dict() if hasattr(st, "as_dict") else dict(st)
    gauges = {"slots"}
    for k, v in d.items():
        if v is None:
            continue
        if k in gauges:
            reg.gauge(f"engine_{k}", f"EngineStats.{k}").set(v)
        else:
            reg.counter(f"engine_{k}_total", f"EngineStats.{k}").inc(v)
    if hasattr(st, "mean_occupancy"):
        reg.gauge("engine_mean_occupancy",
                  "mean busy slots per decode step").set(st.mean_occupancy)

    sigs = engine.step_signatures()
    for k, v in engine.device_steps().items():
        if k in sigs:
            for sig, n in sigs[k].items():
                reg.counter("device_steps_total", "device steps run",
                            labels={"fn": k, "sig": sig}).inc(n)
        else:
            reg.counter("device_steps_total", "device steps run",
                        labels={"fn": k, "sig": ""}).inc(v)

    cache = getattr(engine, "adapter_cache", None)
    if cache is not None and hasattr(cache, "stats"):
        cs = cache.stats().as_dict()
        cache_gauges = {"entries", "current_bytes", "max_bytes",
                        "thrashing", "host_entries", "host_bytes",
                        "host_max_bytes"}
        for k, v in cs.items():
            if v is None:
                continue
            if k in cache_gauges:
                reg.gauge(f"adapter_cache_{k}", f"CacheStats.{k}").set(v)
            else:
                reg.counter(f"adapter_cache_{k}_total",
                            f"CacheStats.{k}").inc(v)

    if getattr(engine, "_paged", False) and hasattr(engine, "pool_stats"):
        for k, v in engine.pool_stats().items():
            if k == "per_slot_blocks":
                for i, n in enumerate(v):
                    reg.gauge("pool_slot_blocks", "blocks owned per slot",
                              labels={"slot": str(i)}).set(n)
            else:
                reg.gauge(f"pool_{k}", f"pool_stats.{k}").set(v)

    if recorder is not None:
        latency_metrics(recorder, reg)
    return reg
