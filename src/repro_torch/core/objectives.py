"""Objective models: latency, energy, average power, energy efficiency.

The paper measures these four objectives with NVML power sensors on two GPUs
(§6.3). Here objectives come from two clearly-separated sources:

* measurements — on a CUDA device, ``measure_formats`` and
  ``core.dataset.collect_dataset(measure=True)`` time the kernels B1–B4
  through the served path (``kernels.ops.compile_spmv``) with CUDA events,
  the L2 flushed before every repetition; on the CPU, ``measure_formats``
  times the plain-torch oracles on the host clock (the reference's
  protocol). They give latency only: power and energy need NVML, which
  nothing here reads yet.
* ``CostModel`` — an analytical model evaluated on exact storage statistics.
  It models the resource trade-offs each schedule knob controls (per-step
  overhead vs tile size, gather/scatter throughput, dense-block vs scalar
  rates, fast-memory feasibility, unroll ILP vs register-spill,
  accumulation precision) and produces all four objectives. The formulas
  take the ``HardwareProfile`` as a parameter; the default profile is
  ``H100_SXM``: data-sheet values where there is one, and documented
  estimates (marked ``# estimate, to be replaced by measurement``)
  elsewhere. It prices the reference's TPU kernels (flat nonzero tiles,
  ``nnz_tile``-step grids), not the card's; where a dataset holds measured
  latencies, the labels and the latency regressor take those, and energy,
  power and efficiency stay the model's.
* ``CardCostModel`` — the card's kernels, B1-B4, as they launch: what each
  launch does (``FormatSpec.card_work``, from the integer launch plans)
  priced by constants fitted on the card (``CardProfile``, ``H100_CARD``,
  ``fit_card_profile``). ``build_tuner`` labels with it on a CUDA device.

Energy accounting follows the paper's measurement protocol (§6.3): idle
power is EXCLUDED — E = FLOPs*e_flop + HBM_bytes*e_hbm + fast_touch*e_vmem +
grid_steps*e_step (dynamic only); avg power = E/t; efficiency = useful
MFLOP/s per watt, with *useful* = 2*nnz (padding compute costs energy but
adds no useful FLOPs — exactly why ELL loses efficiency on power-law
matrices, paper Fig. 10). ``p_static`` remains in the profile for TCO-style
studies but does not enter the four paper objectives.
"""

from __future__ import annotations

import json
import math
import weakref
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from repro_torch.kernels.common import FAST_MEMORY_BYTES, KernelSchedule, resolve_device
from repro_torch.sparse.registry import (  # noqa: F401  (canonical home moved to the
    KernelFootprint,  # format registry; re-exported for backward compatibility)
    MatrixStats,
    get_format,
    format_names,
)

OBJECTIVES = ("latency", "energy", "power", "efficiency")
# for argmin-style selection: efficiency is maximized, the rest minimized
MINIMIZE = {"latency": True, "energy": True, "power": True, "efficiency": False}


@dataclass(frozen=True)
class HardwareProfile:
    """Constants the cost-model formulas read. Field names are shared with
    the reference package so profiles compare one-to-one: ``mxu_*`` is the
    dense-block (tensor-core) rate, ``vpu_*`` the scalar/vector (CUDA-core)
    rate, ``vmem_bytes`` the fast-memory budget, ``grid_step_ns`` the fixed
    cost of one unit of scheduled work."""

    name: str
    mxu_flops_bf16: float  # peak dense-block FLOP/s, bf16 accumulate
    mxu_flops_f32: float
    vpu_flops_bf16: float  # scalar/vector-unit FLOP/s
    vpu_flops_f32: float
    hbm_bw: float  # bytes/s
    gather_rate: float  # in-kernel dynamic-gather elements/s
    scatter_rate: float  # in-kernel scatter-add elements/s
    grid_step_ns: float  # fixed per-step cost
    vmem_bytes: int  # fast-memory budget
    e_flop_bf16: float  # J/FLOP
    e_flop_f32: float
    e_hbm_byte: float  # J/byte
    e_vmem_byte: float
    e_grid_step: float  # J per step (control energy; what makes tiny-tile
    # schedules power-hungry — the occupancy analogue)
    p_static: float  # W
    p_max: float  # W (package cap)


# NVIDIA H100 SXM. Data-sheet values: 989 TFLOP/s bf16 and 495 TFLOP/s TF32
# dense on the tensor cores, 67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s
# HBM3, 50 MB L2, 700 W. Everything else is an engineering estimate.
H100_SXM = HardwareProfile(
    name="h100_sxm",
    mxu_flops_bf16=989e12,
    mxu_flops_f32=495e12,  # TF32
    vpu_flops_bf16=134e12,  # estimate, to be replaced by measurement (2x fp32)
    vpu_flops_f32=67e12,
    hbm_bw=3.35e12,
    gather_rate=1.5e11,  # estimate, to be replaced by measurement
    scatter_rate=5e10,  # estimate, to be replaced by measurement
    grid_step_ns=10.0,  # estimate, to be replaced by measurement
    vmem_bytes=FAST_MEMORY_BYTES,  # the L2: x need not fit in shared memory
    e_flop_bf16=0.3e-12,  # estimate, to be replaced by measurement
    e_flop_f32=0.7e-12,  # estimate, to be replaced by measurement
    e_hbm_byte=32e-12,  # estimate, to be replaced by measurement
    e_vmem_byte=3e-12,  # estimate, to be replaced by measurement
    e_grid_step=2e-9,  # estimate, to be replaced by measurement
    p_static=90.0,  # estimate, to be replaced by measurement
    p_max=700.0,
)

HARDWARE = {"h100_sxm": H100_SXM}


def footprint(
    stats: MatrixStats, fmt: str, schedule: KernelSchedule
) -> KernelFootprint:
    """Exact storage/work statistics for the cost model (no materialization).

    The per-format footprint models live on each registered ``FormatSpec``
    (``repro_torch.sparse.registry``); this is the string-keyed entrypoint the
    cost model and benchmarks use."""
    return get_format(fmt).footprint(stats, schedule)


@dataclass(frozen=True)
class ObjectiveValues:
    latency: float  # seconds
    energy: float  # joules
    power: float  # watts (average)
    efficiency: float  # useful MFLOPS / watt
    feasible: bool = True

    def as_dict(self) -> dict[str, float]:
        return {
            "latency": self.latency,
            "energy": self.energy,
            "power": self.power,
            "efficiency": self.efficiency,
        }

    def get(self, objective: str) -> float:
        return self.as_dict()[objective]


INFEASIBLE = ObjectiveValues(math.inf, math.inf, math.inf, 0.0, feasible=False)


class CostModel:
    def __init__(self, hw: HardwareProfile = H100_SXM):
        self.hw = hw

    def evaluate(
        self, stats: MatrixStats, fmt: str, schedule: KernelSchedule
    ) -> ObjectiveValues:
        hw = self.hw
        fp = footprint(stats, fmt, schedule)
        if not fp.feasible:
            return INFEASIBLE
        bf16 = schedule.accum_dtype == "bfloat16"

        # --- compute time ------------------------------------------------
        mxu_rate = hw.mxu_flops_bf16 if bf16 else hw.mxu_flops_f32
        vpu_rate = hw.vpu_flops_bf16 if bf16 else hw.vpu_flops_f32
        # a matvec keeps only ~1/16 of a dense-block unit busy (one operand
        # is a vector)
        mxu_eff_rate = mxu_rate / 16.0
        # unroll buys gather ILP until the register budget spills; bf16 packs
        # two elements per gather lane
        ilp = 1.0 + 0.18 * math.log2(schedule.unroll)
        live_regs = schedule.unroll * schedule.rows_per_block
        spill = 1.35 if live_regs > 2048 else 1.0
        g_rate = hw.gather_rate * ilp * (1.5 if bf16 else 1.0) / spill
        t_mxu = fp.mxu_fraction * fp.total_flops / mxu_eff_rate
        vpu_flops = (1.0 - fp.mxu_fraction) * fp.total_flops
        t_vpu = vpu_flops / vpu_rate
        t_gather = fp.gather_elems / g_rate
        t_scatter = fp.scatter_elems / (hw.scatter_rate * ilp / spill)
        t_compute = t_mxu + max(t_vpu, t_gather) + t_scatter

        # --- memory time ---------------------------------------------------
        t_mem = fp.hbm_bytes / hw.hbm_bw

        # --- grid overhead (occupancy analogue) ----------------------------
        # double-buffering hides overhead only when tiles are big enough
        pipeline_eff = min(1.0, fp.vmem_resident_bytes / (hw.vmem_bytes * 0.05) + 0.5)
        t_grid = fp.grid_steps * hw.grid_step_ns * 1e-9 / pipeline_eff

        latency = max(t_compute, t_mem) + t_grid

        # --- energy --------------------------------------------------------
        e_flop = hw.e_flop_bf16 if bf16 else hw.e_flop_f32
        elem_bytes = 2.0 if bf16 else 4.0
        vmem_touch = fp.total_flops * elem_bytes  # operand bytes touched in fast memory
        dyn = (
            fp.total_flops * e_flop
            + fp.hbm_bytes * hw.e_hbm_byte
            + vmem_touch * hw.e_vmem_byte
            + (fp.gather_elems + 3 * fp.scatter_elems) * 4.0 * hw.e_vmem_byte
            + fp.grid_steps * hw.e_grid_step
        )
        # idle power excluded, per the paper's §6.3 protocol
        energy = dyn
        power = min(energy / latency, hw.p_max - hw.p_static)
        mflops = fp.useful_flops / latency / 1e6
        return ObjectiveValues(latency, energy, power, mflops / power)


# ---------------------------------------------------------------------------
# the card's cost model: the launches B1-B4 make, priced by a fitted profile
# ---------------------------------------------------------------------------

# the regressors of a CardWork, in the order of a profile's coefficients
CARD_TERMS = ("launch", "bytes", "ctas", "steps", "unroll_steps", "rows", "bf16_steps",
              "stream_steps")


def card_terms(work) -> np.ndarray:
    """The regressors of one launch (a ``registry.CardWork``): 1 (the launch
    floor), bytes, CTAs, steps, steps times the accumulators (a trip's
    loads), rows, steps in bf16, steps with B1's carveout at "stream"."""
    return np.array([1.0, work.bytes, work.ctas, work.steps, work.steps * work.unroll,
                     work.rows, work.steps if work.bf16 else 0.0,
                     work.steps if work.stream else 0.0])


@dataclass(frozen=True)
class CardProfile:
    """Seconds per unit of each of ``CARD_TERMS``, per format (its kernel),
    fitted on the card's measured kernel times (``fit_card_profile``);
    ``n_sms`` is the SM count the launches are planned for."""

    name: str
    n_sms: int
    coef: tuple[tuple[str, tuple[float, ...]], ...]  # (format, per-term seconds)
    source: str = ""  # the run the constants came from

    def of(self, fmt: str) -> tuple[float, ...] | None:
        return dict(self.coef).get(fmt)

    def seconds(self, fmt: str, terms) -> float:
        """The modelled latency of a launch of ``fmt`` with regressors
        ``terms`` (``card_terms``)."""
        coef = self.of(fmt)
        if coef is None:
            raise ValueError(f"profile {self.name} has no constants for {fmt!r}")
        return float(np.dot(coef, terms))


# Fitted by fit_card_profile on the dataset of chip_smoke.py's phase 17 (the
# whole card space on its pool, the CSR space on ten presets cut to n ~
# 14,000; CUDA events, L2 flushed), NVIDIA H100 80GB HBM3, 700.00 W.
H100_CARD = CardProfile(
    name="h100_card",
    n_sms=132,
    coef=(
        ("csr", (6.049e-06, 5.04e-13, 8.405e-10, 1.149e-07, 8.04e-08, 4.642e-07, 1.674e-07,
                 3.395e-08)),
        ("ell", (6.404e-06, 6.297e-13, 0.0, 2.142e-07, 0.0, 0.0, 2.006e-08, 0.0)),
        ("sell", (7.327e-06, 2.163e-13, 2.194e-10, 3.254e-07, 8.282e-08, 0.0, 1.746e-07, 0.0)),
        ("bell", (2.382e-05, 0.0, 6.019e-09, 0.0, 3.232e-07, 0.0, 7.47e-08, 0.0)),
    ),
    source="chip_smoke.py phase 17(b), run B; NVIDIA H100 80GB HBM3, 700.00 W",
)


class CardCostModel:
    """The four objectives of the card's kernels, B1-B4, as they launch.

    Latency is the profile's seconds per unit times what the launch does
    (``FormatSpec.card_work``: from the same integer plans the wrappers
    launch with, ``csr_launch_plan``, ``ell_launch_plan``,
    ``sell_launch_plan`` and ``block_segments``): the launch floor, the
    bytes moved (B1 stores no padding; B2-B4 read up to their padding
    tails), the serial trips of the busiest CTAs (how the CTAs and their
    rows fill the card), B1's rows walked one after another, and those
    trips in bf16 or under B1's "stream" carveout. A point is feasible
    exactly when its ``card_launch`` is (the storage guards, in a
    partition's blocks too) and its plan exists; a format without
    ``card_work`` is not priced (infeasible). Energy, power and efficiency
    are the reference model's formulas on these counts with ``hw``'s
    energy constants, which are estimates until the board's power is
    measured."""

    def __init__(self, profile: CardProfile = H100_CARD, hw: HardwareProfile = H100_SXM):
        self.profile = profile
        self.hw = hw
        # per matrix, the work of each distinct launch: many schedules give one
        self._seen: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()

    def work(self, stats: MatrixStats, fmt: str, schedule: KernelSchedule):
        """The launch's ``CardWork``, or ``None`` where the card does not run
        it (refused storage, no plan, no ``card_work``)."""
        spec = get_format(fmt)
        if spec.card_work is None or spec.card_launch is None:
            return None
        # a launch's work is its float32 twin's but for the accumulator flag
        twin = schedule.replace(accum_dtype="float32")
        try:
            at = spec.card_launch(stats, twin, self.profile.n_sms)
        except ValueError:  # no launch plan for this point
            return None
        if not at.feasible:
            return None
        seen = self._seen.setdefault(stats, {})
        key = (fmt, at.geometry, at.launch)
        if key not in seen:
            seen[key] = spec.card_work(stats, twin, self.profile.n_sms)
        return seen[key]._replace(bf16=schedule.accum_dtype == "bfloat16")

    def evaluate(
        self, stats: MatrixStats, fmt: str, schedule: KernelSchedule
    ) -> ObjectiveValues:
        work = self.work(stats, fmt, schedule)
        if work is None or self.profile.of(fmt) is None:
            return INFEASIBLE
        hw = self.hw
        latency = self.profile.seconds(fmt, card_terms(work))
        e_flop = hw.e_flop_bf16 if work.bf16 else hw.e_flop_f32
        elem_bytes = 2.0 if work.bf16 else 4.0
        energy = (
            work.flops * e_flop
            + work.bytes * hw.e_hbm_byte
            + work.flops * elem_bytes * hw.e_vmem_byte
            + work.gathers * 4.0 * hw.e_vmem_byte
            + work.ctas * hw.e_grid_step
        )
        power = min(energy / latency, hw.p_max - hw.p_static)
        mflops = 2.0 * stats.nnz / latency / 1e6
        return ObjectiveValues(latency, energy, power, mflops / power)


def fit_card_profile(dataset, *, source: str = "",
                     exclude: tuple[str, ...] = ()) -> CardProfile:
    """Least squares of the measured latencies of a card collection
    (``collect_dataset(measure=True, space=CardSpace(...))``) on their
    launches' ``card_terms``, per format, relative error weighted, the
    coefficients held non-negative. The dataset carries each measured
    point's regressors (``meta["card_terms"]``) and the SM count their
    launches were planned for (``meta["n_sms"]``); ``exclude`` leaves
    matrices out (a leave-one-out fit)."""
    rows: dict[str, list] = {}
    ys: dict[str, list] = {}
    terms = dataset.meta.get("card_terms", {})
    for matrix, by_point in terms.items():
        if matrix in exclude:
            continue
        measured = {r.config: r for r in dataset.for_matrix(matrix)
                    if r.source.startswith("measured_")}
        for key, x in by_point:
            r = measured.get(_config_from_key(key))
            if r is None or not r.feasible or not math.isfinite(r.latency):
                continue
            rows.setdefault(r.config.fmt, []).append(x)
            ys.setdefault(r.config.fmt, []).append(r.latency)
    coef = []
    for fmt in rows:
        X = np.asarray(rows[fmt], dtype=np.float64)
        y = np.asarray(ys[fmt], dtype=np.float64)
        coef.append((fmt, tuple(float(c) for c in _nnls(X / y[:, None], np.ones_like(y)))))
    return CardProfile(H100_CARD.name, dataset.meta["n_sms"], tuple(coef), source)


def _config_from_key(key: str):
    from repro_torch.core.dataset import config_of

    return config_of(json.loads(key))


def _nnls(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """min ||A c - b|| over c >= 0 (Lawson and Hanson's active set), columns
    scaled to unit norm first; an all-zero column gets 0."""
    norms = np.linalg.norm(A, axis=0)
    live = norms > 0
    As = A[:, live] / norms[live]
    n = As.shape[1]
    c = np.zeros(n)
    passive = np.zeros(n, dtype=bool)
    for _ in range(3 * n + 10):
        w = As.T @ (b - As @ c)
        if passive.all() or w[~passive].max(initial=0.0) <= 1e-12:
            break
        passive[np.argmax(np.where(passive, -np.inf, w))] = True
        while True:
            z = np.zeros(n)
            z[passive] = np.linalg.lstsq(As[:, passive], b, rcond=None)[0]
            if (z[passive] > 0).all():
                c = z
                break
            neg = passive & (z <= 0)
            alpha = np.min(c[neg] / (c[neg] - z[neg]))
            c = c + alpha * (z - c)
            passive &= c > 1e-15
    out = np.zeros(A.shape[1])
    out[live] = c / norms[live]
    return out


# ---------------------------------------------------------------------------
# measurement-calibrated cost model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FormatCalibration:
    """Per-format affine correction: measured ≈ overhead + scale * modeled.

    The intercept is a real per-launch fixed cost (dispatch/launch setup —
    the term the analytical model omits and the reason it scores k launches
    as free); the slope absorbs systematic bytes/s / nnz/s misestimates.
    ``mean_rel_err`` is a fit diagnostic on the samples used, not a bound.
    """

    launch_overhead_s: float = 0.0
    latency_scale: float = 1.0
    samples: int = 0
    mean_rel_err: float = math.nan

    def as_dict(self) -> dict:
        return {
            "launch_overhead_s": self.launch_overhead_s,
            "latency_scale": self.latency_scale,
            "samples": self.samples,
            "mean_rel_err": self.mean_rel_err,
        }


class CalibratedCostModel:
    """A cost model with per-format affine corrections fit to telemetry.

    The analytical model's *orderings* drive the tuner, but the partition
    planner also needs absolute scale: choosing between 1 launch and k
    launches compares sums of latencies, so a missing per-launch fixed cost
    systematically favours more blocks.
    Corrections are fit per format from (predicted, measured) latency pairs
    accumulated by the telemetry recorder, and applied inside ``evaluate`` —
    ``partition.plan.combine`` then charges k corrected launches against one
    corrected monolithic launch with no planner changes.

    ``base`` is the model whose latencies the corrections scale, and whose
    feasibility stands: the reference-equal ``CostModel(hw)`` by default, as
    in the reference; a session whose plans a ``CardCostModel`` scores
    corrects that model (``AutoSpmvSession.calibrate``), so its storage
    guards and launch counts stay in force.

    With no corrections (or none for the requested format) evaluation is
    byte-identical to the base model, so the class is safe as a drop-in
    default. Energy stays modeled: wall-clock telemetry carries no power
    sensor, and rescaling energy by measured time would double-count the
    overhead in the power term.
    """

    def __init__(
        self,
        hw: HardwareProfile = H100_SXM,
        corrections: dict[str, FormatCalibration] | None = None,
        *,
        base=None,
    ):
        self.hw = hw
        self.base = CostModel(hw) if base is None else base
        self.corrections = dict(corrections or {})

    def evaluate(
        self, stats: MatrixStats, fmt: str, schedule: KernelSchedule
    ) -> ObjectiveValues:
        base = self.base.evaluate(stats, fmt, schedule)
        cal = self.corrections.get(fmt)
        if cal is None or cal.samples <= 0 or not base.feasible:
            return base
        latency = cal.launch_overhead_s + cal.latency_scale * base.latency
        if latency <= 0.0 or not math.isfinite(latency):
            return base
        # energy is unchanged; power/efficiency re-derive from the corrected
        # wall time so the four objectives stay mutually consistent
        useful_flops = base.efficiency * base.power * base.latency * 1e6
        power = min(base.energy / latency, self.hw.p_max - self.hw.p_static)
        mflops = useful_flops / latency / 1e6
        return ObjectiveValues(latency, base.energy, power, mflops / power)

    # ------------------------------------------------------------------ fit
    @staticmethod
    def _fit_one(pairs: list[tuple[float, float]]) -> FormatCalibration | None:
        pts = [(p, m) for p, m in pairs if p > 0.0 and m > 0.0]
        if not pts:
            return None
        pred = np.asarray([p for p, _ in pts], dtype=np.float64)
        meas = np.asarray([m for _, m in pts], dtype=np.float64)
        if len(pts) >= 2 and float(np.ptp(pred)) > 0.0:
            scale, overhead = np.polyfit(pred, meas, 1)
        else:
            scale, overhead = float(meas.mean() / pred.mean()), 0.0
        if scale <= 0.0 or overhead < 0.0:
            # a negative intercept (or inverted slope) means the affine form
            # extrapolates below zero for small kernels; fall back to the
            # always-safe pure rescale
            scale, overhead = float(meas.mean() / pred.mean()), 0.0
        fitted = overhead + scale * pred
        rel_err = float(np.mean(np.abs(fitted - meas) / meas))
        return FormatCalibration(
            launch_overhead_s=float(overhead),
            latency_scale=float(scale),
            samples=len(pts),
            mean_rel_err=rel_err,
        )

    @classmethod
    def fit(
        cls,
        samples: dict[str, list[tuple[float, float]]],
        hw: HardwareProfile = H100_SXM,
        *,
        base=None,
    ) -> "CalibratedCostModel":
        """Fit per-format corrections from (predicted_s, measured_s) pairs;
        ``base``: the model that predicted them."""
        corrections = {}
        for fmt, pairs in samples.items():
            cal = cls._fit_one(list(pairs))
            if cal is not None:
                corrections[fmt] = cal
        return cls(hw, corrections, base=base)

    @classmethod
    def fit_from_telemetry(
        cls, recorder, hw: HardwareProfile = H100_SXM, *, base=None
    ) -> "CalibratedCostModel":
        """Fit from a ``TelemetryRecorder``'s accumulated calibration pairs."""
        return cls.fit(recorder.calibration_samples(), hw, base=base)

    # -------------------------------------------------------------- persist
    def save(self, path) -> None:
        """Persist alongside the tuning cache (atomic, like the cache)."""
        from repro_torch.utils.io import atomic_write_text

        payload = {
            "version": 1,
            "hardware": self.hw.name,
            "base": _base_record(self.base),
            "formats": {f: c.as_dict() for f, c in self.corrections.items()},
        }
        atomic_write_text(path, json.dumps(payload, indent=2, sort_keys=True))

    @classmethod
    def load(cls, path, hw: HardwareProfile | None = None) -> "CalibratedCostModel":
        raw = json.loads(Path(path).read_text())
        if raw.get("version") != 1:
            raise ValueError(f"unsupported calibration version: {raw.get('version')!r}")
        resolved = hw or HARDWARE.get(raw.get("hardware", ""))
        if resolved is None:
            raise ValueError(
                f"calibration names unknown hardware {raw.get('hardware')!r}; "
                f"known: {sorted(HARDWARE)} (pass hw= to override)"
            )
        corrections = {
            fmt: FormatCalibration(
                launch_overhead_s=float(d["launch_overhead_s"]),
                latency_scale=float(d["latency_scale"]),
                samples=int(d["samples"]),
                mean_rel_err=float(d.get("mean_rel_err", math.nan)),
            )
            for fmt, d in raw.get("formats", {}).items()
        }
        return cls(resolved, corrections, base=_base_of(raw.get("base"), resolved))


def _base_record(model) -> dict:
    """What a calibration file says of the model its corrections scale: the
    reference-equal ``CostModel``, or a ``CardCostModel`` with its whole
    profile (a profile fitted at run time has no name of its own)."""
    if isinstance(model, CardCostModel):
        p = model.profile
        return {"model": "CardCostModel", "profile": {
            "name": p.name, "n_sms": p.n_sms, "source": p.source,
            "coef": [[f, list(c)] for f, c in p.coef]}}
    return {"model": type(model).__name__}  # load() rebuilds CostModel only


def _base_of(record: dict | None, hw: HardwareProfile):
    """The base model a calibration file names; a file without one (the
    reference's, or one written before the card's model) corrects the
    reference-equal ``CostModel``."""
    kind = (record or {"model": "CostModel"}).get("model")
    if kind == "CostModel":
        return CostModel(hw)
    if kind == "CardCostModel":
        p = record["profile"]
        profile = CardProfile(p["name"], int(p["n_sms"]),
                              tuple((f, tuple(map(float, c))) for f, c in p["coef"]),
                              p.get("source", ""))
        return CardCostModel(profile, hw)
    raise ValueError(f"calibration corrects an unknown model {kind!r}")


# ---------------------------------------------------------------------------
# measured source — the run-time-mode ground truth
# ---------------------------------------------------------------------------


def measure_formats(
    dense: np.ndarray, reps: int = 3, warmup: int = 1, seed: int = 0, *, device=None
) -> dict[str, float]:
    """Seconds of one SpMV per format at the default schedule on ``device``
    (``None`` = CUDA).

    On a CUDA device: the format's kernel as the served path prepares and
    calls it (``compile_spmv``), the median of ``reps`` CUDA-event timings
    with the L2 flushed before each (``cuda_time_ms``); each format's
    wrapper launches ``warmup + reps`` times, and a format whose ``prepare``
    refuses the storage gets ``inf`` (no launch). On the CPU: the mean wall
    time of the plain-torch oracle (the reference's protocol)."""
    import torch

    from repro_torch.kernels.common import DEFAULT_SCHEDULE, InfeasibleConfig
    from repro_torch.kernels.ops import compile_spmv
    from repro_torch.sparse import from_dense, spmv
    from repro_torch.utils.timing import cuda_time_ms, measure_wall_time

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(
        rng.normal(size=dense.shape[1]).astype(np.float32), device=device
    )
    out = {}
    for fmt in format_names():
        if device.type == "cuda":
            try:
                kernel = compile_spmv(dense, fmt, DEFAULT_SCHEDULE, device=device)
            except InfeasibleConfig:
                out[fmt] = math.inf
                continue
            with torch.cuda.device(device):
                res = cuda_time_ms(lambda: kernel(x), warmup=warmup, reps=reps)
            out[fmt] = res["median_ms"] * 1e-3
        else:
            mat = from_dense(dense, fmt, device=device)
            res = measure_wall_time(lambda: spmv(mat, x), warmup=warmup, reps=reps)
            out[fmt] = res["mean_s"]
    return out
