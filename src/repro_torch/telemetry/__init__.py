"""Telemetry + adaptive reoptimization: the predict→measure→relearn loop.

Auto-SpMV's premise is that the classifier is only as good as its dataset of
measured outcomes (§5.4, §6.1) — yet a cached plan, once wrong, would be
served forever. This package turns every served request into a labelled
measurement and every measurement into a better plan:

* ``recorder``  — per-request ``MeasurementRecord``s with EWMA/percentile
  aggregation per (bucket, objective, format) arm and restart-surviving
  JSONL persistence;
* ``adaptive``  — a UCB bandit layered over the classifier's prior, with a
  bounded exploration budget and a sustained-drift detector that evicts
  stale ``TuningCache`` entries;
* ``feedback``  — exports telemetry as §5.4 ``TuningRecord``s and drives
  incremental refit of the format classifier through ``ml/model_zoo``.

Wiring: ``AutoSpmvSession`` (record/consult hooks, cache invalidation,
``calibrate``), ``SpmvServer`` (timed execution + observe), ``launch/serve.py``
(``--telemetry`` / ``--telemetry-log`` / ``--adaptive`` / ``--refit-every``).
The iterative solvers' SpMV↔SpMSpV policy (``repro_torch.solvers.adaptive``)
runs on the same selector.
"""

from repro_torch.telemetry.adaptive import (
    AdaptiveConfig,
    AdaptiveFormatSelector,
    ArmState,
    CellState,
    block_arm_bucket,
    phase_arm_bucket,
)
from repro_torch.telemetry.feedback import (
    FeedbackConfig,
    FeedbackLoop,
    telemetry_records,
)
from repro_torch.telemetry.recorder import (
    ArmAggregate,
    MeasurementRecord,
    TelemetryRecorder,
)

__all__ = [
    "AdaptiveConfig",
    "AdaptiveFormatSelector",
    "ArmAggregate",
    "ArmState",
    "CellState",
    "FeedbackConfig",
    "FeedbackLoop",
    "MeasurementRecord",
    "TelemetryRecorder",
    "block_arm_bucket",
    "phase_arm_bucket",
    "telemetry_records",
]
