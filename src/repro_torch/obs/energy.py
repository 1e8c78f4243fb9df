"""Per-request energy/power accounting: the paper's four objectives at serve
time.

The paper's claims span latency, energy, average power, and energy
efficiency (§6.3), but only latency is host-observable — there is no power
sensor in this container. The accountant reconstructs the other three the
way ``CalibratedCostModel`` does: energy stays *modeled* (the cost model's
dynamic-energy estimate for the served plan, the one signal wall-clock
cannot contaminate), while average power and efficiency are *re-derived
from the measured wall time* — P = E_model / t_measured, efficiency =
useful MFLOP/s per watt with useful = 2·nnz FLOPs. A plan whose kernel runs
slower than modeled therefore shows its true (lower) average power and
efficiency, which is exactly the §5 energy-efficiency story made visible
per request.

Accumulation is keyed per (format, objective, block): monolithic requests
fold under block ``""``; partitioned serving attributes each row block's
share to its own cell, so a heterogeneous composite shows which block is
burning the joules. Aggregates feed gauges in the metrics registry
(``spmv_energy_joules_total`` / ``spmv_avg_power_watts`` /
``spmv_efficiency_mflops_per_watt``) so the ``/metrics`` scrape carries the
energy story alongside the latency histograms.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from repro_torch.obs.metrics import MetricsRegistry, get_metrics

EnergyKey = tuple[str, str, str]  # (fmt, objective, block)


@dataclass
class EnergyCell:
    """Accumulated accounting for one (fmt, objective, block) cell."""

    requests: int = 0
    latency_s: float = 0.0  # measured wall time, summed
    energy_j: float = 0.0  # modeled dynamic energy, summed
    useful_flops: float = 0.0  # 2*nnz work, summed (efficiency numerator)
    modeled_latency_s: float = 0.0  # the model's own latency claim, summed

    @property
    def avg_power_w(self) -> float:
        return self.energy_j / self.latency_s if self.latency_s > 0 else 0.0

    @property
    def efficiency_mflops_per_w(self) -> float:
        p = self.avg_power_w
        if p <= 0 or self.latency_s <= 0:
            return 0.0
        return self.useful_flops / self.latency_s / 1e6 / p

    def as_dict(self) -> dict:
        return {
            "requests": self.requests,
            "latency_s": self.latency_s,
            "energy_j": self.energy_j,
            "avg_power_w": self.avg_power_w,
            "efficiency_mflops_per_w": self.efficiency_mflops_per_w,
            "modeled_latency_s": self.modeled_latency_s,
        }


@dataclass
class EnergyAccountant:
    """Folds (modeled objectives, measured latency) pairs into per-cell
    aggregates and mirrors them into the metrics registry."""

    registry: MetricsRegistry | None = None
    _cells: dict[EnergyKey, EnergyCell] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def observe(
        self,
        *,
        fmt: str,
        objective: str,
        measured_s: float,
        modeled: dict | None,
        block: str = "",
    ) -> EnergyCell:
        """Account one served execution.

        ``modeled`` is the plan's objective estimate dict (``latency`` /
        ``energy`` / ``power`` / ``efficiency`` — a ``ObjectiveValues
        .as_dict()`` or the predictor's estimate map). Missing or
        non-positive modeled values degrade gracefully: the cell still
        counts the request and its measured latency, contributing zero
        modeled energy."""
        modeled = modeled or {}
        energy = float(modeled.get("energy") or 0.0)
        m_lat = float(modeled.get("latency") or 0.0)
        m_pow = float(modeled.get("power") or 0.0)
        m_eff = float(modeled.get("efficiency") or 0.0)
        # invert efficiency = useful_MFLOPs / (t * P): the modeled triple
        # carries the useful-work numerator without re-deriving nnz here
        useful = m_eff * m_pow * m_lat * 1e6 if m_eff > 0 and m_pow > 0 else 0.0
        key: EnergyKey = (fmt, objective, block)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = EnergyCell()
            cell.requests += 1
            cell.latency_s += max(float(measured_s), 0.0)
            cell.energy_j += energy
            cell.useful_flops += useful
            cell.modeled_latency_s += m_lat
        reg = self.registry if self.registry is not None else get_metrics()
        labels = {"fmt": fmt, "objective": objective}
        if block:
            labels["block"] = block
        reg.gauge("spmv_energy_joules_total", **labels).set(cell.energy_j)
        reg.gauge("spmv_avg_power_watts", **labels).set(cell.avg_power_w)
        reg.gauge("spmv_efficiency_mflops_per_watt", **labels).set(
            cell.efficiency_mflops_per_w
        )
        return cell

    # --------------------------------------------------------------- queries
    def cell(self, fmt: str, objective: str, block: str = "") -> EnergyCell | None:
        return self._cells.get((fmt, objective, block))

    def per_format(self) -> dict[str, EnergyCell]:
        """Cells folded over objectives and blocks — the summary() view."""
        out: dict[str, EnergyCell] = {}
        with self._lock:
            items = list(self._cells.items())
        for (fmt, _obj, _blk), cell in items:
            agg = out.setdefault(fmt, EnergyCell())
            agg.requests += cell.requests
            agg.latency_s += cell.latency_s
            agg.energy_j += cell.energy_j
            agg.useful_flops += cell.useful_flops
            agg.modeled_latency_s += cell.modeled_latency_s
        return out

    def summary(self) -> dict:
        """Per-format aggregates + the full per-cell breakdown."""
        return {
            "per_format": {f: c.as_dict() for f, c in self.per_format().items()},
            "cells": {
                "/".join(k): c.as_dict() for k, c in sorted(self._cells.items())
            },
        }

    def clear(self) -> None:
        with self._lock:
            self._cells.clear()
