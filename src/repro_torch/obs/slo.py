"""SLO burn-rate alerting over the paper's four objectives.

The serving layer maps per-request SLO classes (latency-critical /
power-capped / balanced / energy-saving) onto Auto-SpMV's four tuning
objectives (``models/sparse_linear.SLO_OBJECTIVES``); this module *watches* whether served traffic is actually meeting them. Each SLO
class carries up to three targets — a p99 latency bound, an average-power
cap, and a per-request energy budget, i.e. the measurable faces of the
paper's latency/power/energy objectives (efficiency is their ratio and has
no independent target) — and every served request feeds one sample per
targeted dimension.

Evaluation is SRE-style multi-window burn rate: each (class, dimension)
pair keeps a *fast* and a *slow* ``RollingStats`` window, and the burn rate
is observed/target (windowed p99 over the target for latency, windowed mean
over the cap/budget for power and energy). The alert state machine per
class:

* ``ok`` → ``warning`` when a fast window alone burns hot (short spike, or
  the slow window still remembers healthy traffic);
* ``warning`` → ``firing`` when fast AND slow both burn ≥ 1.0 — the
  violation is sustained, not noise;
* ``firing`` holds while any fast burn stays above the warning threshold
  (hysteresis against flapping) and clears straight to ``ok`` below it.

States are exported as gauges (``slo_alert_state``, ``slo_burn_rate``),
served as JSON on the ``/slo`` endpoint, and consumed by the servers: while
a class is firing, ``effective_objective`` escalates its requests from the
class's native objective to the violated dimension's objective (an
energy-saving class blowing its latency SLO is served latency-tuned plans
until the burn clears). Registered ``on_transition`` hooks fire once per
state change.

Targets default from the paper-derived hardware envelope and are
overridable per class via ``--slo-config`` JSON::

    {"fast_window": 16, "fire_burn": 1.0,
     "targets": {"latency-critical": {"p99_latency_s": 0.05}}}
"""

from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field, replace
from pathlib import Path
from typing import Callable

from repro_torch.obs.metrics import get_metrics
from repro_torch.utils.logging import get_logger
from repro_torch.utils.timing import RollingStats

log = get_logger("obs.slo")

OK, WARNING, FIRING = "ok", "warning", "firing"
STATE_LEVEL = {OK: 0, WARNING: 1, FIRING: 2}

# targetable dimensions, in escalation priority order; each name IS the
# paper objective a firing alert escalates the class to
DIMENSIONS = ("latency", "power", "energy")

# the four SLO classes of models/sparse_linear.SLO_OBJECTIVES (kept as
# literals here so importing the tracker never drags in the model stack;
# config loading validates against this set)
SLO_CLASSES = ("latency-critical", "power-capped", "balanced", "energy-saving")

TransitionHook = Callable[[str, str, str, str | None], None]


@dataclass(frozen=True)
class SloTarget:
    """Per-class targets; ``None`` leaves that dimension untracked."""

    p99_latency_s: float | None = None
    avg_power_w: float | None = None
    energy_per_request_j: float | None = None

    _FIELD_BY_DIMENSION = {
        "latency": "p99_latency_s",
        "power": "avg_power_w",
        "energy": "energy_per_request_j",
    }

    def limit(self, dimension: str) -> float | None:
        return getattr(self, self._FIELD_BY_DIMENSION[dimension])


# The reference package's defaults, kept equal so both packages alert alike
# on the same traffic: the latency-critical class gets the tightest p99,
# power-capped the lowest average-power cap, energy-saving the leanest
# per-request joule budget. They are not derived from the H100's envelope
# (700 W cap): absolute numbers are serving-environment defaults meant to be
# overridden via --slo-config.
DEFAULT_TARGETS: dict[str, SloTarget] = {
    "latency-critical": SloTarget(p99_latency_s=0.25),
    "power-capped": SloTarget(p99_latency_s=2.0, avg_power_w=150.0),
    "balanced": SloTarget(
        p99_latency_s=1.0, avg_power_w=200.0, energy_per_request_j=25.0
    ),
    "energy-saving": SloTarget(p99_latency_s=4.0, energy_per_request_j=5.0),
}


@dataclass(frozen=True)
class SloConfig:
    fast_window: int = 32  # samples: spikes show here first
    slow_window: int = 256  # samples: sustained violations show here
    min_samples: int = 8  # fast-window fill before a dimension may alert
    warn_burn: float = 0.85  # fast burn for warning; also the firing floor
    fire_burn: float = 1.0  # fast AND slow burn to fire
    targets: dict[str, SloTarget] = field(
        default_factory=lambda: dict(DEFAULT_TARGETS)
    )

    @classmethod
    def load(cls, path: str | Path) -> "SloConfig":
        """Build a config from JSON, merging per-class targets over the
        defaults. Unknown top-level keys, class names, or target fields are
        errors — a typo'd SLO config silently tracking nothing is worse
        than a crash at launch."""
        raw = json.loads(Path(path).read_text())
        if not isinstance(raw, dict):
            raise ValueError(f"SLO config must be a JSON object, got {type(raw)}")
        scalar_keys = {
            "fast_window", "slow_window", "min_samples", "warn_burn", "fire_burn"
        }
        unknown = set(raw) - scalar_keys - {"targets"}
        if unknown:
            raise ValueError(f"unknown SLO config key(s): {sorted(unknown)}")
        targets = dict(DEFAULT_TARGETS)
        for slo, fields_ in (raw.get("targets") or {}).items():
            if slo not in SLO_CLASSES:
                raise ValueError(
                    f"unknown SLO class {slo!r}; expected one of {sorted(SLO_CLASSES)}"
                )
            bad = set(fields_) - set(SloTarget._FIELD_BY_DIMENSION.values())
            if bad:
                raise ValueError(
                    f"unknown target field(s) for {slo!r}: {sorted(bad)}"
                )
            targets[slo] = replace(targets[slo], **fields_)
        scalars = {k: raw[k] for k in scalar_keys if k in raw}
        return cls(targets=targets, **scalars)


@dataclass
class _ClassState:
    """Windows + alert state for one SLO class."""

    windows: dict[str, tuple[RollingStats, RollingStats]]  # dim -> (fast, slow)
    state: str = OK
    firing_dimension: str | None = None
    samples: int = 0
    alerts: int = 0  # times this class entered FIRING
    transitions: list[dict] = field(default_factory=list)


class SloTracker:
    """Multi-window burn-rate evaluation + the ok→warning→firing machine.

    Single-owner mutation model (the serving thread observes/evaluates; the
    ``/slo`` scrape thread only reads via ``snapshot``), matching the rest
    of the obs layer.
    """

    def __init__(self, config: SloConfig | None = None, registry=None):
        self.config = config or SloConfig()
        self.metrics = registry if registry is not None else get_metrics()
        self._hooks: list[TransitionHook] = []
        self._classes: dict[str, _ClassState] = {}
        for slo, target in self.config.targets.items():
            windows = {
                dim: (
                    RollingStats(self.config.fast_window),
                    RollingStats(self.config.slow_window),
                )
                for dim in DIMENSIONS
                if target.limit(dim) is not None
            }
            if not windows:
                continue  # a class with every target nulled out: untracked
            self._classes[slo] = _ClassState(windows=windows)
            self.metrics.gauge("slo_alert_state", slo=slo).set(STATE_LEVEL[OK])

    # ----------------------------------------------------------------- hooks
    def on_transition(self, hook: TransitionHook) -> None:
        """Register ``hook(slo, old_state, new_state, dimension)``, called
        once per state change during ``evaluate``."""
        self._hooks.append(hook)

    # --------------------------------------------------------------- observe
    def observe(
        self,
        slo: str,
        *,
        latency_s: float,
        energy_j: float | None = None,
        power_w: float | None = None,
    ) -> None:
        """Feed one served request. ``power_w`` defaults to the energy
        accountant's convention (modeled energy over measured wall time)."""
        st = self._classes.get(slo)
        if st is None:
            return
        st.samples += 1
        if power_w is None and energy_j is not None and latency_s > 0:
            power_w = energy_j / latency_s
        samples = {"latency": latency_s, "power": power_w, "energy": energy_j}
        for dim, value in samples.items():
            pair = st.windows.get(dim)
            if pair is None or value is None:
                continue
            pair[0].add(float(value))
            pair[1].add(float(value))

    # ------------------------------------------------------------ burn rates
    def burn_rates(self, slo: str) -> dict[str, dict[str, float]]:
        """Per targeted dimension: {"fast": burn, "slow": burn} — observed
        over target, so 1.0 means exactly at the SLO boundary."""
        st = self._classes.get(slo)
        if st is None:
            return {}
        target = self.config.targets[slo]
        out: dict[str, dict[str, float]] = {}
        for dim, (fast, slow) in st.windows.items():
            limit = target.limit(dim)
            if not limit or limit <= 0 or fast.count == 0:
                continue
            out[dim] = {
                "fast": self._burn(fast, dim, limit),
                "slow": self._burn(slow, dim, limit),
            }
        return out

    @staticmethod
    def _burn(stats: RollingStats, dim: str, limit: float) -> float:
        if dim == "latency":
            observed = stats.percentile(99.0)
        else:  # power cap / energy budget are averages, not tails
            observed = stats.window_mean()
        if math.isnan(observed):
            return 0.0
        return observed / limit

    # -------------------------------------------------------------- evaluate
    def evaluate(self) -> list[dict]:
        """Advance every class's state machine; returns the transitions.

        Also refreshes the exported gauges, so calling this once per served
        batch keeps the scrape surface current."""
        cfg = self.config
        transitions: list[dict] = []
        for slo, st in self._classes.items():
            burns = self.burn_rates(slo)
            fire_dim = None
            warm = False
            worst_burn = 0.0
            for dim in DIMENSIONS:  # priority order decides the escalation
                b = burns.get(dim)
                if b is None or st.windows[dim][0].count < cfg.min_samples:
                    continue
                worst_burn = max(worst_burn, b["fast"])
                if (
                    fire_dim is None
                    and b["fast"] >= cfg.fire_burn
                    and b["slow"] >= cfg.fire_burn
                ):
                    fire_dim = dim
                if b["fast"] >= cfg.warn_burn:
                    warm = True
            if fire_dim is not None:
                new_state, new_dim = FIRING, fire_dim
            elif st.state == FIRING and warm:
                # hysteresis: hold the alert until the fast burn cools below
                # the warning threshold, then clear straight to ok
                new_state, new_dim = FIRING, st.firing_dimension
            elif warm:
                new_state, new_dim = WARNING, None
            else:
                new_state, new_dim = OK, None
            for dim, b in burns.items():
                self.metrics.gauge(
                    "slo_burn_rate", slo=slo, dimension=dim, window="fast"
                ).set(b["fast"])
                self.metrics.gauge(
                    "slo_burn_rate", slo=slo, dimension=dim, window="slow"
                ).set(b["slow"])
            self.metrics.gauge("slo_alert_state", slo=slo).set(
                STATE_LEVEL[new_state]
            )
            if new_state == st.state:
                st.firing_dimension = new_dim if new_state == FIRING else None
                continue
            old = st.state
            st.state = new_state
            st.firing_dimension = new_dim if new_state == FIRING else None
            if new_state == FIRING:
                st.alerts += 1
                self.metrics.counter("slo_alerts_total", slo=slo).inc()
            rec = {
                "slo": slo,
                "from": old,
                "to": new_state,
                "dimension": st.firing_dimension,
                "burn": worst_burn,
            }
            st.transitions.append(rec)
            del st.transitions[:-64]  # bounded history for the snapshot
            transitions.append(rec)
            log.log(
                30 if new_state == FIRING else 20,
                "slo %s: %s -> %s (dimension=%s, fast burn %.2f)",
                slo, old, new_state, st.firing_dimension, worst_burn,
            )
            for hook in self._hooks:
                hook(slo, old, new_state, st.firing_dimension)
        return transitions

    # ------------------------------------------------------------ escalation
    def state(self, slo: str) -> str:
        st = self._classes.get(slo)
        return st.state if st is not None else OK

    def effective_objective(self, slo: str) -> str:
        """The objective requests of this class should be served under *now*:
        the class's native objective, unless its alert is firing — then the
        violated dimension's objective takes over until the burn clears."""
        from repro_torch.models.sparse_linear import slo_objective  # lazy: torch-heavy

        native = slo_objective(slo)
        st = self._classes.get(slo)
        if st is None or st.state != FIRING or st.firing_dimension is None:
            return native
        escalated = st.firing_dimension  # dimension names ARE objectives
        if escalated != native:
            self.metrics.counter("slo_escalated_requests_total", slo=slo).inc()
        return escalated

    # -------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """The ``/slo`` endpoint / server-summary payload."""
        classes = {}
        for slo, st in self._classes.items():
            classes[slo] = {
                "state": st.state,
                "firing_dimension": st.firing_dimension,
                "samples": st.samples,
                "alerts": st.alerts,
                "targets": {
                    k: v
                    for k, v in asdict(self.config.targets[slo]).items()
                    if v is not None
                },
                "burn_rates": self.burn_rates(slo),
                "transitions": list(st.transitions[-8:]),
            }
        return {
            "config": {
                "fast_window": self.config.fast_window,
                "slow_window": self.config.slow_window,
                "min_samples": self.config.min_samples,
                "warn_burn": self.config.warn_burn,
                "fire_burn": self.config.fire_burn,
            },
            "classes": classes,
        }
