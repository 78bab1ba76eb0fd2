"""Engine observability (counterpart of ``repro/obs``): request-lifecycle
tracing, latency metrics, and export surfaces (JSONL / Chrome trace /
Prometheus text / JSON).

Contract (held by tests/test_torch_obs.py): observability is FREE and
INVARIANT. A :class:`TraceRecorder` threaded through
``DecodeEngine(trace=...)`` reads only host mirrors the scheduler
already maintains, so tracing on vs. off leaves token streams equal,
``stats()``, ``device_steps()`` and ``step_signatures()`` unchanged, and
adds no device read-back. Pure Python: the port keeps its own copy.
"""
from repro_torch.obs.metrics import (SECONDS_BUCKETS, TICK_BUCKETS, Counter,
                                     Gauge, Histogram, MetricsRegistry,
                                     engine_metrics, latency_metrics,
                                     lifecycle_latencies, parse_prometheus,
                                     percentile)
from repro_torch.obs.trace import (AUX_EVENTS, EVENT_NAMES, LIFECYCLE_EVENTS,
                                   TraceEvent, TraceRecorder, monotonic)

__all__ = [
    "AUX_EVENTS", "Counter", "EVENT_NAMES", "Gauge", "Histogram",
    "LIFECYCLE_EVENTS", "MetricsRegistry", "SECONDS_BUCKETS",
    "TICK_BUCKETS", "TraceEvent", "TraceRecorder", "engine_metrics",
    "latency_metrics", "lifecycle_latencies", "monotonic",
    "parse_prometheus", "percentile",
]
