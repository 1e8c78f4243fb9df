"""Observability for the served SpMV path: tracing, metrics, energy accounting.

* ``trace``   — nested spans (``session.optimize`` → ``cache.lookup`` →
  ``kernel.compile`` → ``kernel.execute``) with crash-tolerant JSONL export
  and an optional ``torch.profiler`` capture hook;
* ``metrics`` — a process-wide registry of counters/gauges/histograms with
  JSON snapshot + Prometheus text export;
* ``energy``  — per-request modeled-energy / measured-latency accounting of
  the four paper objectives, per (format, objective, block).

``obs_enabled``/``set_obs_enabled`` gate the whole layer: disabled, a span
is one attribute read and a metric mutation is one boolean check. The
reference package's HTTP endpoint, SLO tracker, anomaly watchdog, fleet sync
and shard aggregation are later slices.
"""

from repro_torch.obs.energy import EnergyAccountant, EnergyCell
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_metrics,
    reset_metrics,
)
from repro_torch.obs.trace import (
    Tracer,
    get_tracer,
    load_spans,
    profile_capture,
    span,
)


def set_obs_enabled(enabled: bool) -> None:
    """Flip tracing + metrics on/off process-wide (the no-op fast path)."""
    get_tracer().enabled = enabled
    get_metrics().enabled = enabled


def obs_enabled() -> bool:
    return get_tracer().enabled or get_metrics().enabled


__all__ = [
    "Counter",
    "EnergyAccountant",
    "EnergyCell",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Tracer",
    "get_metrics",
    "get_tracer",
    "load_spans",
    "obs_enabled",
    "profile_capture",
    "reset_metrics",
    "set_obs_enabled",
    "span",
]
