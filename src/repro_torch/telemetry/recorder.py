"""Per-request measurement records + per-arm aggregation (telemetry core).

Every served SpMV request becomes a ``MeasurementRecord``: which plan was
served (feature bucket, objective, format, schedule), what the model
predicted, and what the wall clock actually measured. The recorder folds
records into per-*arm* aggregates — an arm is a (bucket, objective, format)
cell, exactly the granularity the paper's §5.4 dataset labels — keeping an
all-time mean, an EWMA that tracks drift, and windowed percentiles
(``repro_torch.utils.timing.RollingStats``).

Persistence is a JSONL append-log. Appends are line-atomic in practice and
``load``/``replay`` skip a torn trailing line (the one thing a crash during
an append can produce), so telemetry state survives restarts the same way
the ``TuningCache`` does; a full rewrite via temp-file + ``os.replace``
would be crash-safe too but O(total records) per flush, which an append-log
exists to avoid. Replaying the log rebuilds every aggregate, so there is no
separate snapshot file to corrupt.
"""

from __future__ import annotations

import json
import os
from collections import deque
from dataclasses import asdict, dataclass, field
from pathlib import Path

from repro_torch.utils.logging import get_logger
from repro_torch.utils.timing import RollingStats

log = get_logger("telemetry.recorder")

TELEMETRY_LOG_VERSION = 1

# Per-format window of (predicted_s, measured_s) pairs kept for cost-model
# calibration (``CalibratedCostModel.fit_from_telemetry``). Windowed so a
# long-running server calibrates against recent hardware behaviour, not the
# full history.
CALIBRATION_WINDOW = 256

ArmKey = tuple[str, str, str]  # (bucket, objective, fmt)


@dataclass(frozen=True)
class MeasurementRecord:
    """One served request turned into a labelled measurement."""

    seq: int  # monotonically increasing per recorder lifetime
    bucket: str  # feature bucket (plan-cache key component)
    objective: str
    fmt: str  # format actually served
    measured_s: float  # measured kernel wall time
    predicted_s: float | None = None  # model's latency estimate for the plan
    plan_id: str = ""  # "bucket/objective/mode" the plan resolved to
    exploratory: bool = False  # bandit exploration pull, not the incumbent
    schedule: dict = field(default_factory=dict)  # KernelSchedule.as_dict()
    features: dict = field(default_factory=dict)  # Table-2 features (dataset export)
    source: str = "serve"

    def as_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)


@dataclass
class ArmAggregate:
    """Aggregated outcomes for one (bucket, objective, fmt) arm."""

    key: ArmKey
    stats: RollingStats
    schedule: dict = field(default_factory=dict)  # representative schedule
    exploratory_pulls: int = 0

    def as_dict(self) -> dict:
        d = self.stats.as_dict()
        d["exploratory_pulls"] = self.exploratory_pulls
        return d


class TelemetryRecorder:
    """Low-overhead measurement sink with JSONL persistence.

    Parameters
    ----------
    log_path:
        Optional JSONL file. If it exists, its records are replayed into
        the aggregates on construction (restart survival); new records are
        appended in batches of ``flush_every``.
    window / ewma_alpha:
        Per-arm ``RollingStats`` parameters.
    """

    def __init__(
        self,
        log_path: str | Path | None = None,
        *,
        window: int = 128,
        ewma_alpha: float = 0.2,
        flush_every: int = 32,
    ):
        self.log_path = Path(log_path) if log_path is not None else None
        self.window = int(window)
        self.ewma_alpha = float(ewma_alpha)
        self.flush_every = max(int(flush_every), 1)
        self.seq = 0
        self.records_dropped = 0  # malformed lines skipped at load
        self._arms: dict[ArmKey, ArmAggregate] = {}
        self._bucket_features: dict[str, dict] = {}
        self._pending: list[MeasurementRecord] = []
        # must exist before _replay: replayed records fold calibration pairs
        self._calibration: dict[str, deque] = {}
        self._calibration_totals: dict[str, int] = {}  # monotonic, survives
        # window resets — pollers diff against it to find fresh pairs
        if self.log_path is not None and self.log_path.exists():
            self._replay(self.log_path)

    # ---------------------------------------------------------------- record
    def observe(
        self,
        *,
        bucket: str,
        objective: str,
        fmt: str,
        measured_s: float,
        predicted_s: float | None = None,
        plan_id: str = "",
        exploratory: bool = False,
        schedule: dict | None = None,
        features: dict | None = None,
        source: str = "serve",
    ) -> MeasurementRecord:
        """Build + record a measurement (kwargs keep callers import-free)."""
        rec = MeasurementRecord(
            seq=self.seq,
            bucket=bucket,
            objective=objective,
            fmt=fmt,
            measured_s=float(measured_s),
            predicted_s=None if predicted_s is None else float(predicted_s),
            plan_id=plan_id,
            exploratory=bool(exploratory),
            schedule=dict(schedule or {}),
            features=dict(features or {}),
            source=source,
        )
        self.record(rec)
        return rec

    def record(self, rec: MeasurementRecord) -> None:
        self.seq = max(self.seq, rec.seq) + 1
        self._fold(rec)
        if self.log_path is not None:
            self._pending.append(rec)
            if len(self._pending) >= self.flush_every:
                self.flush()

    def _fold(self, rec: MeasurementRecord) -> None:
        key: ArmKey = (rec.bucket, rec.objective, rec.fmt)
        arm = self._arms.get(key)
        if arm is None:
            arm = ArmAggregate(
                key, RollingStats(self.window, self.ewma_alpha), dict(rec.schedule)
            )
            self._arms[key] = arm
        arm.stats.add(rec.measured_s)
        if rec.schedule:
            arm.schedule = dict(rec.schedule)
        if rec.exploratory:
            arm.exploratory_pulls += 1
        if rec.features:
            self._bucket_features[rec.bucket] = dict(rec.features)
        if (
            rec.predicted_s is not None
            and rec.predicted_s > 0.0
            and rec.measured_s > 0.0
        ):
            pairs = self._calibration.get(rec.fmt)
            if pairs is None:
                pairs = self._calibration[rec.fmt] = deque(maxlen=CALIBRATION_WINDOW)
            pairs.append((rec.predicted_s, rec.measured_s))
            self._calibration_totals[rec.fmt] = (
                self._calibration_totals.get(rec.fmt, 0) + 1
            )

    # --------------------------------------------------------------- queries
    def arm(self, bucket: str, objective: str, fmt: str) -> ArmAggregate | None:
        return self._arms.get((bucket, objective, fmt))

    def arms(self) -> dict[ArmKey, ArmAggregate]:
        return dict(self._arms)

    def arms_for(self, bucket: str, objective: str) -> dict[str, ArmAggregate]:
        """Per-format aggregates of one (bucket, objective) cell."""
        return {
            k[2]: a for k, a in self._arms.items() if k[0] == bucket and k[1] == objective
        }

    def bucket_features(self, bucket: str) -> dict | None:
        return self._bucket_features.get(bucket)

    def calibration_samples(
        self, fmt: str | None = None
    ) -> dict[str, list[tuple[float, float]]] | list[tuple[float, float]]:
        """(predicted_s, measured_s) pairs per format — the calibration input.

        Only records that carried a model prediction contribute; pairs are
        windowed to the most recent ``CALIBRATION_WINDOW`` per format.
        """
        if fmt is not None:
            return list(self._calibration.get(fmt, ()))
        return {f: list(pairs) for f, pairs in self._calibration.items()}

    def calibration_totals(self) -> dict[str, int]:
        """Monotonic per-format count of calibration pairs ever folded.

        ``calibration_samples`` is a bounded window, so a poller (the
        ``obs/anomaly.py`` watchdog) cannot tell fresh pairs from ones it
        already judged; diffing against these totals can. Window resets do
        not rewind them."""
        return dict(self._calibration_totals)

    def reset_calibration(self, fmt: str | None = None) -> int:
        """Drop the windowed calibration pairs (one format, or all).

        The anomaly watchdog calls this when a format's residuals say its
        pairs were produced by a lying cost model — the next
        ``fit_from_telemetry`` must not least-squares over the lying era.
        Returns the number of pairs dropped; totals stay monotonic."""
        if fmt is not None:
            return len(self._calibration.pop(fmt, ()))
        dropped = sum(len(p) for p in self._calibration.values())
        self._calibration.clear()
        return dropped

    def total_observations(self) -> int:
        return sum(a.stats.count for a in self._arms.values())

    def summary(self) -> dict:
        expl = sum(a.exploratory_pulls for a in self._arms.values())
        return {
            "observations": self.total_observations(),
            "arms": len(self._arms),
            "buckets": len({k[0] for k in self._arms}),
            "exploratory_pulls": expl,
            "records_dropped": self.records_dropped,
            "pending": len(self._pending),
            "calibration_samples": sum(
                len(p) for p in self._calibration.values()
            ),
        }

    # ----------------------------------------------------------- persistence
    def flush(self) -> int:
        """Append pending records to the JSONL log; returns lines written."""
        if self.log_path is None or not self._pending:
            n = len(self._pending)
            self._pending.clear()
            return n
        self.log_path.parent.mkdir(parents=True, exist_ok=True)
        chunk = "".join(r.as_json() + "\n" for r in self._pending)
        # a crash mid-append can leave the file without a trailing newline;
        # appending onto that torn line would corrupt the next record too
        if self.log_path.exists() and self.log_path.stat().st_size:
            with open(self.log_path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    chunk = "\n" + chunk
        with open(self.log_path, "a") as f:
            f.write(chunk)
            f.flush()
            os.fsync(f.fileno())
        n = len(self._pending)
        self._pending.clear()
        return n

    def _replay(self, path: Path) -> None:
        loaded = 0
        for line in path.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                raw = json.loads(line)
                rec = MeasurementRecord(**raw)
            except (ValueError, TypeError):
                # torn trailing line from an interrupted append, or a
                # foreign/newer schema row: telemetry is advisory, skip it
                self.records_dropped += 1
                continue
            self.seq = max(self.seq, rec.seq + 1)
            self._fold(rec)
            loaded += 1
        log.info(
            "replayed %d telemetry records from %s (%d dropped)",
            loaded,
            path,
            self.records_dropped,
        )

    def close(self) -> None:
        self.flush()
