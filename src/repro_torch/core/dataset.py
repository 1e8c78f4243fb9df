"""Dataset collection harness (paper §5.4 step 2, §6.1).

Builds the labelled tuning dataset: every (matrix x configuration) cell gets
the four objective values. The paper collected 15,520 records over 30
matrices on two GPUs (~70 M kernel runs); here each cell gets an analytical
cost-model record on exact storage statistics (``source="model_<hw>"``)
and, with ``measure=True``, measured latencies:

* over the card's space (``space=CardSpace(...)``), one record per point
  (one per distinct launch) with its schedule, timed through the kernels on
  a CUDA device (``source="measured_cuda"``; CUDA events, L2 flushed), the
  storage converted once per (matrix, format, geometry); then the points
  within ``RETIME_WITHIN`` of their format's best are timed again in turns,
  and the matrix's label is the best of those in-turn medians;
* over any other space, one record per format at the default schedule
  (``measure_formats``), as the reference does.

A measured record carries latency only (energy, power and efficiency are
NaN: they need NVML). ``best_record`` takes an objective's label from the
records that carry it, latency from the measured ones where a matrix has
them (from the in-turn medians where the matrix was timed again), and
treats measured times within the matrix's spread as ties. The model that
labels the records is ``model`` (``CostModel`` on ``hw`` by default; the
card's is ``objectives.CardCostModel``).
``scale`` shrinks matrices for laptop-scale collection while preserving the
feature spread (generate.py).
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np

from repro_torch.core.features import SparsityFeatures, extract_features, features_from_row_counts
from repro_torch.core.objectives import (
    MINIMIZE,
    OBJECTIVES,
    HardwareProfile,
    MatrixStats,
    CostModel,
    H100_SXM,
    card_terms,
    measure_formats,
)
from repro_torch.core.tuning_space import CardSpace, TuningConfig, full_space, tie_order
from repro_torch.kernels.common import (
    DEFAULT_SCHEDULE,
    InfeasibleConfig,
    KernelSchedule,
    resolve_device,
)
from repro_torch.sparse.generate import MATRIX_NAMES, PATTERN_NAMES, generate_by_name, random_matrix
from repro_torch.utils.io import atomic_write_text
from repro_torch.utils.logging import get_logger

log = get_logger("core.dataset")

# After a matrix's first pass, the points within RETIME_WITHIN of their
# format's best (at most RETIME_MAX of a format, the fastest) are timed again
# in turns: RETIME_ROUNDS rounds, each in order and then in reverse (A B B A).
# Their in-turn medians tie within the in-turn spread, and never within less
# than RETIME_TIE: on an H100 the gap between two points moved between calls
# by 0.5-0.9 % at the median and 1.3-1.5 % at the 90th percentile, which
# timing in turns within one call cannot see
RETIME_WITHIN = 0.05
RETIME_MAX = 8
RETIME_ROUNDS = 4
RETIME_TIE = 0.015


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
        """The matrix's best feasible record for ``objective`` among the
        records that carry it (not NaN). Latency comes from the measured
        records where the matrix has some; measured times within the
        matrix's spread (``meta["spread"]``, relative) of the fastest are
        ties, broken by ``tuning_space.tie_order`` (the default first, then
        fewer rows per block and accumulators), so labels do not flip
        between collections."""
        cands = [
            r
            for r in self.for_matrix(matrix)
            if r.feasible
            and (formats is None or r.config.fmt in formats)
            and not math.isnan(r.objective(objective))
        ]
        if not cands:
            raise ValueError(f"no feasible record for {matrix}")
        measured = [r for r in cands if objective == "latency" and is_measured(r)]
        if measured:
            cands = measured
        key = lambda r: r.objective(objective)
        best = min(cands, key=key) if MINIMIZE[objective] else max(cands, key=key)
        retimed = self.meta.get("retime", {}).get(matrix) if measured else None
        if retimed is not None:
            median = dict(zip(map(config_of, retimed["candidates"]), retimed["median_ms"]))
            timed = [r for r in cands if r.config in median]
            if timed:
                fastest = min(median[r.config] for r in timed)
                ties = [r for r in timed
                        if median[r.config] <= fastest * (1.0 + retimed["spread"])]
                return min(ties, key=lambda r: tie_order(r.config))
        spread = self.meta.get("spread", {}).get(matrix) if measured else None
        if spread is not None:
            ties = [r for r in cands if r.latency <= best.latency * (1.0 + spread)]
            best = min(ties, key=lambda r: tie_order(r.config))
        return best

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
        blob = json.loads(Path(path).read_text())
        records = []
        for row in blob["records"]:
            records.append(
                TuningRecord(
                    matrix=row["matrix"],
                    features=SparsityFeatures(**row["features"]),
                    config=config_of(row["config"]),
                    latency=row["latency"],
                    energy=row["energy"],
                    power=row["power"],
                    efficiency=row["efficiency"],
                    feasible=row["feasible"],
                    source=row["source"],
                )
            )
        return cls(records, blob.get("meta", {}))


def config_of(d: Mapping) -> TuningConfig:
    """The ``TuningConfig`` of its ``as_dict()``."""
    cfg = dict(d)
    fmt = cfg.pop("fmt")
    return TuningConfig(fmt, KernelSchedule(**cfg))


def is_measured(record: TuningRecord) -> bool:
    """Whether a record's latency was measured (``source="measured_<device>"``)."""
    return record.source.startswith("measured_")


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


def host_timer(fn: Callable, reps: int) -> dict[str, float]:
    """``fn`` on the host clock: one call to warm up, then the median and
    quartiles of ``reps`` calls, in milliseconds (the CPU's timer for the
    card's space; its plain versions)."""
    from repro_torch.utils.timing import percentile

    fn()
    ms = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        fn()
        ms.append(1e3 * (time.perf_counter() - t0))
    return {"median_ms": percentile(ms, 50), "q1_ms": percentile(ms, 25),
            "q3_ms": percentile(ms, 75)}


def _measure_card(ds: TuningDataset, name: str, dense: np.ndarray, feats, stats,
                  space: CardSpace, points: list[TuningConfig], dev, reps: int,
                  timer: Callable | None, on_point: Callable | None) -> None:
    """Time every point of ``points`` on ``dev``: storage converted once per
    (format, geometry) through ``compile_spmv``, each point called through
    the served path; then the matrix's candidates again, in turns
    (``_retime``). The default schedule's geometry of each format is
    converted first and alone, as a served conversion is, and its seconds
    kept (``meta["overhead"]``); the rest share one scan of the dense
    matrix."""
    import torch

    from repro_torch.kernels.ops import PreparedSpmv, compile_spmv
    from repro_torch.sparse.formats import shared_nonzeros
    from repro_torch.utils.timing import _block, cuda_time_ms

    if timer is None:
        if dev.type == "cuda":
            def timer(fn, cfg):
                with torch.cuda.device(dev):
                    return cuda_time_ms(fn, warmup=2, reps=reps)
        else:
            def timer(fn, cfg):
                return host_timer(fn, reps)
    meta, secs = ds.meta, ds.meta["seconds"]
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=dense.shape[1]).astype(np.float32), device=dev)
    storage: dict[tuple, list[TuningConfig]] = {}
    admitted: dict[tuple, bool] = {}
    for cfg in points:
        at = space.launch(stats, cfg)
        storage.setdefault((cfg.fmt, at.geometry), []).append(cfg)
        admitted[(cfg.fmt, at.geometry)] = at.feasible
    defaults = {(f, space.launch(stats, TuningConfig(f, DEFAULT_SCHEDULE)).geometry): f
                for f in dict.fromkeys(cfg.fmt for cfg in points)}
    conversion_s = {}
    spreads = []
    conversions = 0
    kept: dict[tuple, object] = {}  # storage of geometries that may hold a candidate
    group_best: dict[tuple, float] = {}  # each kept geometry's best time
    best: dict[str, float] = {}  # each format's best time so far

    def call_of(prepared, cfg, last):
        kernel = PreparedSpmv(prepared.mat, cfg.schedule, dev)

        def call():
            last[:] = [kernel(x)]
            meta["calls"][cfg.fmt] = meta["calls"].get(cfg.fmt, 0) + 1
            return last[0]
        return kernel, call

    def convert(key):
        nonlocal conversions
        if not admitted[key]:
            return None
        t0 = time.perf_counter()
        try:
            prepared = compile_spmv(dense, key[0], storage[key][0].schedule, device=dev)
            _block(prepared.mat)
            conversions += 1
        except InfeasibleConfig:
            prepared = None
        took = time.perf_counter() - t0
        secs["conversion"] += took
        if key in defaults and prepared is not None:
            conversion_s[key[0]] = took
        return prepared

    # the default geometries alone (a served conversion), then the rest
    # sharing one scan; the records keep the points' order
    early = {key: convert(key) for key in defaults}
    with shared_nonzeros(dense):
        for key, cfgs in storage.items():
            prepared = early.pop(key) if key in early else convert(key)
            fastest = math.inf
            for cfg in cfgs:
                latency = math.inf
                if prepared is not None:
                    last = []
                    kernel, call = call_of(prepared, cfg, last)
                    t0 = time.perf_counter()
                    got = timer(call, cfg)
                    secs["timing"] += time.perf_counter() - t0
                    latency = got["median_ms"] * 1e-3
                    spreads.append((got["q3_ms"] - got["q1_ms"]) / got["median_ms"])
                refused = prepared is not None and on_point is not None and (
                    on_point(name, cfg, kernel, x, last[0]) is False)
                feasible = math.isfinite(latency) and not refused
                ds.records.append(TuningRecord(
                    matrix=name, features=feats, config=cfg, latency=latency,
                    energy=math.nan, power=math.nan, efficiency=math.nan,
                    feasible=feasible, source=f"measured_{dev.type}"))
                if feasible:
                    fastest = min(fastest, latency)
            fmt = key[0]
            if math.isfinite(fastest) and fastest <= best.get(fmt, math.inf) * (1.0 + RETIME_WITHIN):
                kept[key], group_best[key] = prepared, fastest
                best[fmt] = min(best.get(fmt, math.inf), fastest)
                for k in [k for k in kept if k[0] == fmt]:
                    if group_best[k] > best[fmt] * (1.0 + RETIME_WITHIN):
                        del kept[k]
    meta["spread"][name] = float(np.median(spreads)) if spreads else 0.0
    meta["conversions"][name] = conversions
    meta["overhead"].setdefault(name, {})["conversion_s"] = {
        f: conversion_s.get(f) for f in defaults.values()}
    _retime(ds, name, space, stats, kept, call_of, timer)


def _retime(ds: TuningDataset, name: str, space: CardSpace, stats, kept: dict,
            call_of: Callable, timer: Callable) -> None:
    """Time a matrix's candidates again, in turns: per format its feasible
    points within ``RETIME_WITHIN`` of the format's best (the
    ``RETIME_MAX`` fastest), all of them in ``RETIME_ROUNDS`` rounds, each
    in order and then in reverse. ``meta["retime"][name]`` keeps the
    candidates, each one's timings and their median, and the in-turn
    spread: the median over the candidates of the relative interquartile
    range of each one's timings across the turns (the variation a median
    of one timing carries, not that of one repetition), at least
    ``RETIME_TIE``."""
    records = [r for r in ds.for_matrix(name) if is_measured(r) and r.feasible]
    cands: list[TuningConfig] = []
    for fmt in dict.fromkeys(r.config.fmt for r in records):
        mine = sorted((r for r in records if r.config.fmt == fmt),
                      key=lambda r: (r.latency, tie_order(r.config)))
        near = [r.config for r in mine if r.latency <= mine[0].latency * (1.0 + RETIME_WITHIN)]
        cands += near[:RETIME_MAX]
    calls = {}
    for cfg in cands:
        prepared = kept[(cfg.fmt, space.launch(stats, cfg).geometry)]
        calls[cfg] = call_of(prepared, cfg, [])[1]
    if not cands:
        return
    ms = {cfg: [] for cfg in cands}
    t0 = time.perf_counter()
    for _ in range(RETIME_ROUNDS):
        for cfg in cands + cands[::-1]:
            ms[cfg].append(timer(calls[cfg], cfg)["median_ms"])
    took = time.perf_counter() - t0
    ds.meta["seconds"]["timing"] += took

    def rel_iqr(v):
        q1, med, q3 = np.percentile(v, [25, 50, 75])
        return float((q3 - q1) / med)
    ds.meta["retime"][name] = {
        "candidates": [c.as_dict() for c in cands], "rounds": RETIME_ROUNDS,
        "calls": sum(map(len, ms.values())), "seconds": took, "ms": [ms[c] for c in cands],
        "median_ms": [float(np.median(ms[c])) for c in cands],
        "spread": max(float(np.median([rel_iqr(v) for v in ms.values()])), RETIME_TIE)}


def _card_terms_of(stats, space: CardSpace, points: list[TuningConfig]) -> list:
    """[config key, ``card_terms``] of each point whose launch the card runs:
    what ``objectives.fit_card_profile`` regresses the measured times on."""
    from repro_torch.sparse.registry import get_format

    out, work_of = [], {}
    for cfg in points:
        spec = get_format(cfg.fmt)
        if spec.card_work is None or not space.launch(stats, cfg).feasible:
            continue
        # a launch's work is its float32 twin's but for the accumulator flag
        twin = (cfg.fmt, cfg.schedule.replace(accum_dtype="float32"))
        if twin not in work_of:
            work_of[twin] = spec.card_work(stats, twin[1], space.n_sms)
        work = work_of[twin]._replace(bf16=cfg.schedule.accum_dtype == "bfloat16")
        out.append([json.dumps(cfg.as_dict(), sort_keys=True), card_terms(work).tolist()])
    return out


def collect_dataset(
    *,
    scale: float = 0.002,
    names: Sequence[str] = MATRIX_NAMES,
    n_extra: int = 0,
    hw: HardwareProfile = H100_SXM,
    space: Sequence[TuningConfig] | CardSpace | None = None,
    measure: bool = False,
    measure_reps: int = 3,
    device=None,
    matrices: Mapping[str, np.ndarray] | Iterable[tuple[str, np.ndarray]] | None = None,
    timer: Callable | None = None,
    on_point: Callable | None = None,
    model=None,
) -> TuningDataset:
    """Evaluate every (matrix x config) cell; returns the labelled dataset.

    ``model`` labels the model records (``source="model_<name>"``): by
    default the reference-equal ``CostModel(hw)``; the card's is
    ``objectives.CardCostModel``.

    The cost-model records touch no tensor; ``device`` matters only with
    ``measure=True`` (``None`` = CUDA). ``matrices`` (name -> dense, or an
    iterable of such pairs, generated as it is read) replaces the suite of
    ``names`` at ``scale`` and the ``n_extra`` augmentation matrices.

    With ``space`` a ``CardSpace`` each matrix contributes its own points
    (one per distinct launch), and ``measure=True`` times each of them
    (``measure_reps`` repetitions): on a CUDA device with ``cuda_time_ms``,
    every repetition one launch of the format's kernel, on the CPU on the
    host clock. ``timer(fn, config)`` replaces that timer; it returns
    ``median_ms``, ``q1_ms`` and ``q3_ms``. ``on_point(matrix, config,
    kernel, x, y)`` sees each timed point with the ``y`` of its last call;
    returning ``False`` refuses the point (its record stays, infeasible, so
    no label or fit takes it).
    ``meta`` then holds each matrix's spread (median relative
    interquartile range of its points), the conversions per matrix, the
    calls made per format (``calls``: the launches, on a card, the
    re-timing's included), the re-timing (``retime``: see ``_retime``), the
    §5.3 overhead at the matrix's size (``overhead``: the seconds of its
    feature pass, and per format of the conversion of the default
    schedule's geometry, ``None`` where the guard refuses it;
    ``core.overhead.overhead_samples`` reads them) and the wall seconds
    split into generation, features, model, conversion and timing."""
    card = isinstance(space, CardSpace)
    if not card:
        space = list(space) if space is not None else list(full_space())
    t0 = time.time()
    if matrices is None:
        matrices = _suite_matrices(scale, names)
        matrices.update(_extra_matrices(n_extra))
    model = CostModel(hw) if model is None else model
    source = f"model_{getattr(model, 'profile', model.hw).name}"
    ds = TuningDataset(
        meta={
            "scale": scale,
            "hw": hw.name,
            "model": source,
            "n_configs": None if card else len(space),
            "n_matrices": None,
            "collected_unix": time.time(),
        }
    )
    if card and measure:
        ds.meta.update(spread={}, conversions={}, calls={}, retime={}, overhead={},
                       card_terms={}, n_sms=space.n_sms,
                       seconds=dict.fromkeys(
                           ("generation", "features", "model", "conversion", "timing"), 0.0))
        ds.meta["seconds"]["generation"] = time.time() - t0
    items = iter(matrices.items() if isinstance(matrices, Mapping) else matrices)
    n_configs = mi = 0
    while True:
        t_gen = time.perf_counter()
        try:
            name, dense = next(items)
        except StopIteration:
            break
        t_feat = time.perf_counter()
        if measure:  # the feature pass as run-time mode pays it (§5.3)
            feats = extract_features(dense)
            features_s = time.perf_counter() - t_feat
            stats = MatrixStats(dense)
        else:  # labels alone: the row histogram the statistics already hold
            stats = MatrixStats(dense)
            feats = features_from_row_counts(stats.row_counts, stats.n_rows)
        points = space.points(stats) if card else space
        t_model = time.perf_counter()
        for cfg in points:
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
                    source=source,
                )
            )
        n_configs += len(points)
        if card and measure:
            secs = ds.meta["seconds"]
            secs["generation"] += t_feat - t_gen
            secs["features"] += t_model - t_feat
            ds.meta["card_terms"][name] = _card_terms_of(stats, space, points)
            secs["model"] += time.perf_counter() - t_model
            ds.meta["overhead"][name] = {"features_s": features_s}
            _measure_card(ds, name, dense, feats, stats, space, points,
                          resolve_device(device), measure_reps, timer, on_point)
        elif measure:
            dev = resolve_device(device)
            times = measure_formats(dense, reps=measure_reps, device=dev)
            for fmt, t in times.items():
                # these records carry the default schedule: one time per
                # format, as the reference measures its oracles
                ds.records.append(
                    TuningRecord(
                        matrix=name,
                        features=feats,
                        config=TuningConfig(fmt, DEFAULT_SCHEDULE),
                        latency=t,
                        energy=float("nan"),
                        power=float("nan"),
                        efficiency=float("nan"),
                        feasible=math.isfinite(t),
                        source=f"measured_{dev.type}",
                    )
                )
        mi += 1
        if mi % 10 == 0:
            log.info("collected %d matrices (%.1fs)", mi, time.time() - t0)
    ds.meta["n_matrices"] = mi
    if card:
        ds.meta["n_configs"] = n_configs
    log.info(
        "dataset: %d records (%d matrices, %d configs) in %.1fs",
        len(ds),
        mi,
        n_configs,
        time.time() - t0,
    )
    return ds
