"""The paper's primary contribution: the Auto-SpMV tuning framework.

features -> dataset -> predictors -> {compile-time, run-time} optimization,
plus the objective models (analytical cost model + measured oracles) and
the AutoML (HPO) stage.
"""

from repro_torch.core.autotuner import (
    AutoSpMV,
    CompileTimePlan,
    CompileTimeResult,
    RunTimePlan,
    RunTimeResult,
    should_convert,
)
from repro_torch.core.cache import CacheEntry, TuningCache, feature_bucket
from repro_torch.core.dataset import TuningDataset, TuningRecord, collect_dataset
from repro_torch.core.features import (
    FEATURE_NAMES,
    SparsityFeatures,
    extract_features,
    features_from_assignment_histogram,
    features_from_csr_indptr,
)
from repro_torch.core.objectives import (
    HARDWARE,
    MINIMIZE,
    OBJECTIVES,
    MatrixStats,
    ObjectiveValues,
    CalibratedCostModel,
    CostModel,
    H100_SXM,
    HardwareProfile,
    footprint,
    measure_formats,
)
from repro_torch.core.overhead import OverheadPredictor, OverheadSample, measure_overheads
from repro_torch.core.predictor import AutoSpmvPredictor, PredictorConfig
from repro_torch.core.session import (
    AutoSpmvSession,
    PartitionedResult,
    ServedPlan,
    SessionStats,
    build_tuner,
)
from repro_torch.core.tuning_space import (
    ALL_KNOBS,
    KNOBS,
    PAPER_KNOBS,
    TuningConfig,
    compile_time_space,
    full_space,
    knob_value,
    schedule_space,
)


def __getattr__(name):
    if name == "DEFAULT_CONFIG":
        # forwarded per access — see tuning_space.__getattr__
        from repro_torch.core import tuning_space

        return tuning_space.DEFAULT_CONFIG
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "AutoSpMV",
    "AutoSpmvSession",
    "CacheEntry",
    "CompileTimePlan",
    "CompileTimeResult",
    "RunTimePlan",
    "RunTimeResult",
    "PartitionedResult",
    "ServedPlan",
    "SessionStats",
    "TuningCache",
    "build_tuner",
    "feature_bucket",
    "should_convert",
    "TuningDataset",
    "TuningRecord",
    "collect_dataset",
    "FEATURE_NAMES",
    "SparsityFeatures",
    "extract_features",
    "features_from_assignment_histogram",
    "features_from_csr_indptr",
    "HARDWARE",
    "MINIMIZE",
    "OBJECTIVES",
    "MatrixStats",
    "ObjectiveValues",
    "CalibratedCostModel",
    "CostModel",
    "H100_SXM",
    "HardwareProfile",
    "footprint",
    "measure_formats",
    "OverheadPredictor",
    "OverheadSample",
    "measure_overheads",
    "AutoSpmvPredictor",
    "PredictorConfig",
    "ALL_KNOBS",
    "DEFAULT_CONFIG",
    "KNOBS",
    "PAPER_KNOBS",
    "TuningConfig",
    "compile_time_space",
    "full_space",
    "knob_value",
    "schedule_space",
]
