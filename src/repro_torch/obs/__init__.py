"""Unified observability: tracing, metrics, energy accounting, aggregation.

The paper's claims are about *measured* latency, energy, average power, and
efficiency; this package is how the serving reproduction observes all four
instead of just wall clock. Four pieces, threaded through every hot path:

* ``trace``   — nested spans (``session.optimize`` → ``cache.lookup`` →
  ``kernel.compile`` → ``kernel.execute``) with crash-tolerant JSONL export
  and an optional ``torch.profiler`` capture hook;
* ``metrics`` — a process-wide registry of counters/gauges/histograms with
  JSON snapshot + Prometheus text export;
* ``energy``  — per-request modeled-energy / measured-latency accounting of
  the four paper objectives, per (format, objective, block);
* ``aggregate`` — merges JSONL metric/trace/posterior shards from N server
  instances into one fleet report; ``http`` serves ``/metrics`` +
  ``/healthz`` + ``/obs`` + ``/slo`` from a daemon thread.

On top of that passive layer sits the *active* one (alerting and reacting,
not just recording):

* ``slo``     — per-SLO-class targets with SRE-style multi-window burn-rate
  evaluation, an ok→warning→firing alert state machine, and objective
  escalation hooks the servers consume;
* ``anomaly`` — a cost-model residual watchdog over the recorder's
  calibration pairs that recalibrates + evicts when the model is lying;
* ``sync``    — live fleet posterior sync through a shared directory of
  shards (``FleetSync`` + ``AdaptiveFormatSelector.absorb``).

``obs_enabled``/``set_obs_enabled`` gate the whole layer: disabled, a span
is one attribute read and a metric mutation is one boolean check — the
serving path's no-op fast path. The tracer starts off (``trace.tracing()`` or
``set_obs_enabled(True)`` switches it on); the metrics registry starts on.
"""

from repro_torch.obs.aggregate import merge_shards
from repro_torch.obs.anomaly import AnomalyConfig, CostModelWatchdog
from repro_torch.obs.energy import EnergyAccountant, EnergyCell
from repro_torch.obs.http import ObsHTTPServer
from repro_torch.obs.slo import SloConfig, SloTarget, SloTracker
from repro_torch.obs.sync import FleetSync, write_fleet_shard
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
    "AnomalyConfig",
    "CostModelWatchdog",
    "Counter",
    "EnergyAccountant",
    "EnergyCell",
    "FleetSync",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ObsHTTPServer",
    "SloConfig",
    "SloTarget",
    "SloTracker",
    "Tracer",
    "get_metrics",
    "get_tracer",
    "load_spans",
    "merge_shards",
    "obs_enabled",
    "profile_capture",
    "reset_metrics",
    "set_obs_enabled",
    "span",
    "write_fleet_shard",
]
