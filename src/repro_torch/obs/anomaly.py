"""Cost-model residual watchdog: catch "the model is lying" before regret.

The bandit's drift signals (telemetry/adaptive.py) notice a *plan* serving
worse than its rivals — that takes many pulls per cell to accumulate. This
watchdog attacks the upstream failure directly: it streams the
(predicted_s, measured_s) calibration pairs the ``TelemetryRecorder``
already keeps per format, tracks an EWMA of the relative residual
``|measured - predicted| / predicted``, and compares it against a baseline
of healthy residuals (anomalous when the EWMA exceeds
``max(rel_threshold, baseline_mean + z_threshold * baseline_std)`` for
``sustain`` consecutive polls with fresh data).

On a sustained anomaly it assumes the cost model is lying about that format
and repairs the pipeline in one shot:

1. drop the format's calibration window (``recorder.reset_calibration``) —
   the lying era's pairs must not be least-squares'd into the next fit;
2. ``session.calibrate()`` — replaces the session's cost model with a fresh
   fit; with the anomalous format's window empty it falls back to the
   analytical base model for that format and relearns the affine correction
   from post-recovery measurements;
3. ``session.evict_format(fmt)`` — targeted drift eviction of every cached
   plan serving that format (monolithic or as a partitioned component), so
   the next request re-plans against the repaired model.

Consumption bookkeeping rides on ``recorder.calibration_totals()`` (a
monotonic per-format counter), so each poll judges only pairs it has not
seen — a bounded window alone cannot tell fresh pairs from replayed ones.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.obs.metrics import get_metrics
from repro_torch.utils.logging import get_logger
from repro_torch.utils.timing import RollingStats, ewma as _ewma

log = get_logger("obs.anomaly")


@dataclass(frozen=True)
class AnomalyConfig:
    ewma_alpha: float = 0.4  # residual EWMA: reactive, a few pairs to swing
    rel_threshold: float = 0.75  # absolute floor: EWMA residual below this
    # is never anomalous, however tight the healthy baseline ran
    z_threshold: float = 4.0  # sigmas above the healthy baseline mean
    sustain: int = 2  # consecutive anomalous polls (with fresh pairs) to fire
    min_samples: int = 6  # healthy residuals before the baseline can judge
    baseline_window: int = 128


@dataclass
class _FormatState:
    baseline: RollingStats  # healthy-era residuals only
    ewma: float | None = None
    consumed: int = 0  # vs recorder.calibration_totals()[fmt]
    strikes: int = 0
    anomalies: int = 0
    pairs_seen: int = 0


class CostModelWatchdog:
    """Per-format residual monitor bound to one ``AutoSpmvSession``."""

    def __init__(self, session, config: AnomalyConfig | None = None, registry=None):
        if session.telemetry is None:
            raise ValueError(
                "CostModelWatchdog needs a session with a telemetry recorder "
                "(the calibration pairs are its input)"
            )
        self.session = session
        self.config = config or AnomalyConfig()
        self.metrics = registry if registry is not None else get_metrics()
        self.recalibrations = 0
        self._formats: dict[str, _FormatState] = {}

    # ------------------------------------------------------------------ poll
    def poll(self) -> list[str]:
        """Consume fresh calibration pairs; returns the formats that fired."""
        cfg = self.config
        recorder = self.session.telemetry
        fired: list[str] = []
        for fmt, total in recorder.calibration_totals().items():
            st = self._formats.get(fmt)
            if st is None:
                st = self._formats[fmt] = _FormatState(
                    RollingStats(cfg.baseline_window)
                )
            fresh = total - st.consumed
            if fresh <= 0:
                continue
            pairs = recorder.calibration_samples(fmt)
            st.consumed = total
            take = pairs[-min(fresh, len(pairs)):] if pairs else []
            if not take:
                continue  # window was reset since those pairs were folded
            residuals = [
                abs(measured - predicted) / predicted
                for predicted, measured in take
            ]
            for r in residuals:
                st.ewma = _ewma(st.ewma, r, cfg.ewma_alpha)
            st.pairs_seen += len(residuals)
            self.metrics.gauge("costmodel_residual_ewma", fmt=fmt).set(st.ewma)
            if self._anomalous(st):
                st.strikes += 1
                self.metrics.gauge("costmodel_anomaly_strikes", fmt=fmt).set(
                    st.strikes
                )
                if st.strikes >= cfg.sustain:
                    self._fire(fmt, st)
                    fired.append(fmt)
            else:
                st.strikes = 0
                self.metrics.gauge("costmodel_anomaly_strikes", fmt=fmt).set(0)
                for r in residuals:  # healthy: teach the baseline
                    st.baseline.add(r)
        return fired

    def _anomalous(self, st: _FormatState) -> bool:
        cfg = self.config
        if st.ewma is None or st.baseline.count < cfg.min_samples:
            return False
        threshold = max(
            cfg.rel_threshold,
            st.baseline.mean + cfg.z_threshold * st.baseline.std,
        )
        return st.ewma > threshold

    # ------------------------------------------------------------------ fire
    def _fire(self, fmt: str, st: _FormatState) -> None:
        recorder = self.session.telemetry
        dropped_pairs = recorder.reset_calibration(fmt)
        self.session.calibrate()
        evicted = self.session.evict_format(fmt)
        self.recalibrations += 1
        st.anomalies += 1
        st.strikes = 0
        st.ewma = None
        st.consumed = recorder.calibration_totals().get(fmt, st.consumed)
        # the old baseline described the pre-anomaly model; relearn it
        st.baseline = RollingStats(self.config.baseline_window)
        self.metrics.counter("costmodel_anomalies_total", fmt=fmt).inc()
        self.metrics.counter("costmodel_recalibrations_total").inc()
        log.warning(
            "cost-model anomaly on %s: residual ewma blew past the healthy "
            "baseline; dropped %d lying calibration pairs, recalibrated, "
            "evicted %d cached plan(s)",
            fmt, dropped_pairs, evicted,
        )

    # --------------------------------------------------------------- summary
    def summary(self) -> dict:
        return {
            "formats": {
                fmt: {
                    "residual_ewma": st.ewma,
                    "baseline_mean": st.baseline.mean if st.baseline.count else None,
                    "baseline_samples": st.baseline.count,
                    "strikes": st.strikes,
                    "anomalies": st.anomalies,
                    "pairs_seen": st.pairs_seen,
                }
                for fmt, st in sorted(self._formats.items())
            },
            "recalibrations": self.recalibrations,
        }
