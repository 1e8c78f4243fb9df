"""Process-wide metrics registry: counters, gauges, latency histograms.

One registry per process (``get_metrics``), shared by every instrumented
module — the plan cache counts hits/misses, the kernel memo counts
compiles/evictions, the bandit counts explore/exploit pulls, the server
feeds latency histograms. Two export surfaces:

* ``snapshot()`` — a JSON-able dict (the ``/obs`` endpoint and
  ``SpmvServer.dump_obs``);
* ``to_prometheus()`` — the text exposition format a Prometheus scraper
  accepts on ``/metrics`` (histograms render as summaries with
  p50/p90/p99 quantile labels, built on ``utils/timing.RollingStats``).

``write_shard``/JSONL lines are the fleet substrate: each server instance
dumps its instruments as one line per metric and ``obs/aggregate.py`` merges
N shards into one report (counters sum, gauges average, histogram windows
concatenate so fleet percentiles are recomputed over real samples).

Disabled mode (``registry.enabled = False``) turns every mutation into a
single attribute check — instrument handles stay valid, nothing accumulates.
``reset()`` zeroes instruments *in place* so module-level cached handles
survive test isolation.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from pathlib import Path

from repro_torch.utils.timing import RollingStats

METRICS_SCHEMA_VERSION = 1

# quantiles every histogram exports (summary-style), per the serving story:
# median, tail, and deep tail of request latency
QUANTILES = (50.0, 90.0, 99.0)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if not name or not (name[0].isalpha() or name[0] in "_:"):
        name = "_" + name
    return name


def _prom_labels(labels: tuple[tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{_prom_name(k)}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
             for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    """Monotonic float counter."""

    __slots__ = ("registry", "name", "labels", "value")

    def __init__(self, registry: "MetricsRegistry", name: str, labels):
        self.registry = registry
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if self.registry.enabled:
            with self.registry._lock:
                self.value += n

    def _reset(self) -> None:
        self.value = 0.0


class Gauge:
    """Last-written value (set) with optional add/sub."""

    __slots__ = ("registry", "name", "labels", "value")

    def __init__(self, registry: "MetricsRegistry", name: str, labels):
        self.registry = registry
        self.name = name
        self.labels = labels
        self.value = math.nan

    def set(self, v: float) -> None:
        if self.registry.enabled:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        if self.registry.enabled:
            with self.registry._lock:
                self.value = (0.0 if math.isnan(self.value) else self.value) + n

    def _reset(self) -> None:
        self.value = math.nan


class Histogram:
    """Latency histogram on ``RollingStats``: exact count/sum, windowed
    percentiles (p50/p90/p99 over the last ``window`` samples)."""

    __slots__ = ("registry", "name", "labels", "stats")

    def __init__(self, registry: "MetricsRegistry", name: str, labels,
                 window: int = 512):
        self.registry = registry
        self.name = name
        self.labels = labels
        self.stats = RollingStats(window=window)

    def observe(self, v: float) -> None:
        if self.registry.enabled:
            with self.registry._lock:
                self.stats.add(v)

    @property
    def count(self) -> int:
        return self.stats.count

    @property
    def sum(self) -> float:
        return self.stats.mean * self.stats.count

    def percentile(self, q: float) -> float:
        return self.stats.percentile(q)

    def quantiles(self) -> dict[str, float]:
        return {f"p{int(q)}": self.stats.percentile(q) for q in QUANTILES}

    def as_dict(self) -> dict:
        d = {"count": self.count, "sum": self.sum, "mean": self.stats.mean}
        d.update(self.quantiles())
        return d

    def recent(self) -> list[float]:
        """The windowed samples (shard export: fleet percentile merging)."""
        return [float(x) for x in self.stats._recent]

    def _reset(self) -> None:
        self.stats = RollingStats(window=self.stats.window)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create instrument store, keyed by (kind, name, labels)."""

    def __init__(self, *, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.RLock()
        self._instruments: dict[tuple, object] = {}

    # ------------------------------------------------------------ instruments
    def _get(self, kind: str, name: str, labels: dict, **kwargs):
        key = (kind, name, tuple(sorted(labels.items())))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = _KINDS[kind](self, name, key[2], **kwargs)
                self._instruments[key] = inst
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, window: int = 512, **labels) -> Histogram:
        return self._get("histogram", name, labels, window=window)

    def instruments(self, kind: str | None = None, name: str | None = None):
        """Registered instruments, optionally filtered by kind and/or name."""
        with self._lock:
            return [
                inst
                for (k, n, _), inst in self._instruments.items()
                if (kind is None or k == kind) and (name is None or n == name)
            ]

    def reset(self) -> None:
        """Zero every instrument IN PLACE (handles cached at call sites in
        hot-path modules stay valid across test isolation)."""
        with self._lock:
            for inst in self._instruments.values():
                inst._reset()

    # ----------------------------------------------------------------- export
    def snapshot(self) -> dict:
        """JSON-able view of every instrument (the ``/obs`` payload)."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            items = list(self._instruments.items())
        for (kind, name, labels), inst in items:
            key = name + _prom_labels(labels)
            if kind == "counter":
                out["counters"][key] = inst.value
            elif kind == "gauge":
                out["gauges"][key] = inst.value
            else:
                out["histograms"][key] = inst.as_dict()
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (``/metrics`` payload)."""
        by_name: dict[tuple[str, str], list] = {}
        with self._lock:
            items = list(self._instruments.items())
        for (kind, name, labels), inst in items:
            by_name.setdefault((kind, _prom_name(name)), []).append((labels, inst))
        lines = []
        for (kind, name), insts in sorted(by_name.items(), key=lambda kv: kv[0][1]):
            lines.append(f"# TYPE {name} {'summary' if kind == 'histogram' else kind}")
            for labels, inst in insts:
                if kind == "counter":
                    lines.append(f"{name}{_prom_labels(labels)} {inst.value:g}")
                elif kind == "gauge":
                    v = inst.value
                    lines.append(
                        f"{name}{_prom_labels(labels)} "
                        f"{'NaN' if math.isnan(v) else format(v, 'g')}"
                    )
                else:
                    for q in QUANTILES:
                        p = inst.percentile(q)
                        qlabel = 'quantile="{:g}"'.format(q / 100.0)
                        lines.append(
                            f"{name}{_prom_labels(labels, qlabel)} "
                            f"{'NaN' if math.isnan(p) else format(p, 'g')}"
                        )
                    lines.append(f"{name}_sum{_prom_labels(labels)} {inst.sum:g}")
                    lines.append(f"{name}_count{_prom_labels(labels)} {inst.count}")
        return "\n".join(lines) + "\n"

    def shard_lines(self, instance: str = "") -> list[str]:
        """One JSONL line per instrument — the fleet-aggregation shard."""
        lines = []
        with self._lock:
            items = list(self._instruments.items())
        header = {
            "kind": "meta",
            "schema": METRICS_SCHEMA_VERSION,
            "instance": instance,
            "ts": time.time(),
        }
        lines.append(json.dumps(header, sort_keys=True))
        for (kind, name, labels), inst in items:
            rec: dict = {"kind": kind, "name": name, "labels": dict(labels),
                         "instance": instance}
            if kind == "histogram":
                rec["count"] = inst.count
                rec["sum"] = inst.sum
                rec["recent"] = inst.recent()
            else:
                rec["value"] = inst.value
            lines.append(json.dumps(rec, sort_keys=True))
        return lines

    def write_shard(self, path: str | Path, instance: str = "") -> Path:
        """Atomically write this instance's metrics shard (JSONL)."""
        from repro_torch.utils.io import atomic_write_text

        return atomic_write_text(
            path, "\n".join(self.shard_lines(instance)) + "\n"
        )


_REGISTRY = MetricsRegistry()


def get_metrics() -> MetricsRegistry:
    """The process-wide registry every instrumented module shares."""
    return _REGISTRY


def reset_metrics() -> None:
    """Zero the process registry in place (test isolation)."""
    _REGISTRY.reset()
