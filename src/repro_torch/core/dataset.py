"""Dataset collection harness (paper §5.4 step 2, §6.1).

Builds the labelled tuning dataset: every (matrix x configuration) cell gets
the four objective values. The paper collected 15,520 records over 30
matrices on two GPUs (~70 M kernel runs); here each record is an analytical
cost-model evaluation on exact storage statistics plus (optionally)
measured wall-times of the per-format plain-torch oracles. Replacing the
cost-model labels by CUDA-event and NVML measurements is a later slice. ``scale``
shrinks matrices for laptop-scale collection while preserving the feature
spread (generate.py).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Sequence

import numpy as np

from repro_torch.core.features import SparsityFeatures, extract_features
from repro_torch.core.objectives import (
    MINIMIZE,
    OBJECTIVES,
    HardwareProfile,
    MatrixStats,
    CostModel,
    H100_SXM,
    measure_formats,
)
from repro_torch.core.tuning_space import TuningConfig, full_space
from repro_torch.kernels.common import resolve_device
from repro_torch.sparse.generate import MATRIX_NAMES, PATTERN_NAMES, generate_by_name, random_matrix
from repro_torch.utils.io import atomic_write_text
from repro_torch.utils.logging import get_logger

log = get_logger("core.dataset")


@dataclass
class TuningRecord:
    matrix: str
    features: SparsityFeatures
    config: TuningConfig
    latency: float
    energy: float
    power: float
    efficiency: float
    feasible: bool
    source: str  # "model_<hw>" or "measured_<device type>"

    def objective(self, name: str) -> float:
        return getattr(self, name)


@dataclass
class TuningDataset:
    records: list[TuningRecord] = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.records)

    @property
    def matrices(self) -> list[str]:
        seen: dict[str, None] = {}
        for r in self.records:
            seen.setdefault(r.matrix, None)
        return list(seen)

    def for_matrix(self, name: str) -> list[TuningRecord]:
        return [r for r in self.records if r.matrix == name]

    def feasible(self) -> list[TuningRecord]:
        return [r for r in self.records if r.feasible]

    # --- label construction ------------------------------------------------
    def best_record(
        self, matrix: str, objective: str, *, formats: Sequence[str] | None = None
    ) -> TuningRecord:
        cands = [
            r
            for r in self.for_matrix(matrix)
            if r.feasible and (formats is None or r.config.fmt in formats)
        ]
        if not cands:
            raise ValueError(f"no feasible record for {matrix}")
        key = lambda r: r.objective(objective)
        return min(cands, key=key) if MINIMIZE[objective] else max(cands, key=key)

    def default_record(self, matrix: str) -> TuningRecord:
        from repro_torch.core.tuning_space import DEFAULT_CONFIG

        for r in self.for_matrix(matrix):
            if r.config == DEFAULT_CONFIG:
                return r
        raise ValueError(f"default config missing for {matrix}")

    # --- serialization -------------------------------------------------------
    def save(self, path: str | Path) -> None:
        path = Path(path)
        rows = []
        for r in self.records:
            row = {
                "matrix": r.matrix,
                "features": r.features.dict(),
                "config": r.config.as_dict(),
                "latency": r.latency,
                "energy": r.energy,
                "power": r.power,
                "efficiency": r.efficiency,
                "feasible": r.feasible,
                "source": r.source,
            }
            rows.append(row)
        atomic_write_text(path, json.dumps({"meta": self.meta, "records": rows}))

    @classmethod
    def load(cls, path: str | Path) -> "TuningDataset":
        from repro_torch.kernels.common import KernelSchedule

        blob = json.loads(Path(path).read_text())
        records = []
        for row in blob["records"]:
            cfg = dict(row["config"])
            fmt = cfg.pop("fmt")
            records.append(
                TuningRecord(
                    matrix=row["matrix"],
                    features=SparsityFeatures(**row["features"]),
                    config=TuningConfig(fmt, KernelSchedule(**cfg)),
                    latency=row["latency"],
                    energy=row["energy"],
                    power=row["power"],
                    efficiency=row["efficiency"],
                    feasible=row["feasible"],
                    source=row["source"],
                )
            )
        return cls(records, blob.get("meta", {}))


def _suite_matrices(scale: float, names: Sequence[str]) -> dict[str, np.ndarray]:
    return {name: generate_by_name(name, scale=scale) for name in names}


def _extra_matrices(n_extra: int, seed: int = 100) -> dict[str, np.ndarray]:
    """Augmentation matrices: patterns x sizes x seeds (robustness; the
    paper's 30 unique feature vectors alone make thin training data)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n_extra):
        pattern = PATTERN_NAMES[i % len(PATTERN_NAMES)]
        n = int(rng.integers(256, 3000))
        avg = float(rng.uniform(2, min(48, n / 8)))
        out[f"synth_{pattern}_{i}"] = random_matrix(n, avg, pattern, seed=int(rng.integers(1e9)))
    return out


def collect_dataset(
    *,
    scale: float = 0.002,
    names: Sequence[str] = MATRIX_NAMES,
    n_extra: int = 0,
    hw: HardwareProfile = H100_SXM,
    space: Sequence[TuningConfig] | None = None,
    measure: bool = False,
    measure_reps: int = 3,
    device=None,
) -> TuningDataset:
    """Evaluate every (matrix x config) cell; returns the labelled dataset.

    The cost-model records touch no tensor; ``device`` matters only with
    ``measure=True``, which times the per-format oracles there (``None`` =
    CUDA)."""
    space = list(space) if space is not None else list(full_space())
    matrices = _suite_matrices(scale, names)
    matrices.update(_extra_matrices(n_extra))
    model = CostModel(hw)
    ds = TuningDataset(
        meta={
            "scale": scale,
            "hw": hw.name,
            "n_configs": len(space),
            "n_matrices": len(matrices),
            "collected_unix": time.time(),
        }
    )
    t0 = time.time()
    for mi, (name, dense) in enumerate(matrices.items()):
        feats = extract_features(dense)
        stats = MatrixStats(dense)
        for cfg in space:
            vals = model.evaluate(stats, cfg.fmt, cfg.schedule)
            ds.records.append(
                TuningRecord(
                    matrix=name,
                    features=feats,
                    config=cfg,
                    latency=vals.latency,
                    energy=vals.energy,
                    power=vals.power,
                    efficiency=vals.efficiency,
                    feasible=vals.feasible,
                    source=f"model_{hw.name}",
                )
            )
        if measure:
            dev = resolve_device(device)
            times = measure_formats(dense, reps=measure_reps, device=dev)
            for fmt, t in times.items():
                from repro_torch.kernels.common import DEFAULT_SCHEDULE

                # measured records carry the default schedule (the schedule
                # knobs do not exist for the plain-torch oracles)
                ds.records.append(
                    TuningRecord(
                        matrix=name,
                        features=feats,
                        config=TuningConfig(fmt, DEFAULT_SCHEDULE),
                        latency=t,
                        energy=float("nan"),
                        power=float("nan"),
                        efficiency=float("nan"),
                        feasible=True,
                        source=f"measured_{dev.type}",
                    )
                )
        if (mi + 1) % 10 == 0:
            log.info("collected %d/%d matrices (%.1fs)", mi + 1, len(matrices), time.time() - t0)
    log.info(
        "dataset: %d records (%d matrices x %d configs) in %.1fs",
        len(ds),
        len(matrices),
        len(space),
        time.time() - t0,
    )
    return ds
