"""The Auto-SpMV configuration space (format x compile-time schedule).

``KNOBS`` maps each of the paper's tunable parameters to its field on
``KernelSchedule`` (see ``kernels/common.py`` for what each steers on the
card): ``tb_size`` -> rows_per_block, ``maxrregcount`` -> unroll, ``memory``
-> x_residency; ``nnz_tile`` and ``accum_dtype`` are extras beyond the
paper's three, reported separately. ``KNOBS``, the choice sets,
``schedule_space`` and ``full_space`` are the reference package's.

``CardSpace`` is the space as the card runs it: many schedules give one
launch (B1 never reads ``nnz_tile``; ELL planes aligned to 32 or 64 rows
are the same planes), so per matrix it keeps one point per distinct
(storage geometry, launch), from integers through each format's
``FormatSpec.card_launch``. ``CARD_KNOBS`` are the knobs that reach a
parameter of B1, the compile-time mode's kernel.

The paper's *default* configuration (its comparison baseline) is the CSR
format with untuned compiler parameters; ours is CSR with the default
schedule.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Hashable, Iterator, Sequence

from repro_torch.kernels.common import (
    ACCUM_DTYPE_CHOICES,
    DEFAULT_SCHEDULE,
    H100_SMS,
    NNZ_TILE_CHOICES,
    ROWS_PER_BLOCK_CHOICES,
    UNROLL_CHOICES,
    X_RESIDENCY_CHOICES,
    KernelSchedule,
)
from repro_torch.sparse.registry import CardLaunch, default_format, format_names, get_format


@dataclass(frozen=True)
class TuningConfig:
    fmt: str
    schedule: KernelSchedule

    def as_dict(self) -> dict:
        d = {"fmt": self.fmt}
        d.update(self.schedule.as_dict())
        return d


def __getattr__(name):
    if name == "DEFAULT_CONFIG":
        # resolved per access (PEP 562), not frozen at import: a plugin that
        # registers itself below the seeds' priority becomes the default
        # everywhere at once — including this baseline config
        return TuningConfig(default_format(), DEFAULT_SCHEDULE)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

# paper knob name -> (KernelSchedule field, choices)
KNOBS: dict[str, tuple[str, tuple]] = {
    "tb_size": ("rows_per_block", ROWS_PER_BLOCK_CHOICES),
    "maxrregcount": ("unroll", UNROLL_CHOICES),
    "memory": ("x_residency", X_RESIDENCY_CHOICES),
    "nnz_tile": ("nnz_tile", NNZ_TILE_CHOICES),
    "accum_dtype": ("accum_dtype", ACCUM_DTYPE_CHOICES),
}
PAPER_KNOBS = ("tb_size", "maxrregcount", "memory")  # Table 5 columns
ALL_KNOBS = tuple(KNOBS)


def schedule_space(
    rows_per_block=ROWS_PER_BLOCK_CHOICES,
    nnz_tile=NNZ_TILE_CHOICES,
    unroll=UNROLL_CHOICES,
    accum_dtype=ACCUM_DTYPE_CHOICES,
    x_residency=X_RESIDENCY_CHOICES,
) -> Iterator[KernelSchedule]:
    """All valid schedules in the (sub)space (invalid combos skipped)."""
    for rpb, nt, u, acc, xr in itertools.product(
        rows_per_block, nnz_tile, unroll, accum_dtype, x_residency
    ):
        if nt % u:
            continue  # unroll must divide the tile
        yield KernelSchedule(
            rows_per_block=rpb,
            nnz_tile=nt,
            unroll=u,
            accum_dtype=acc,
            x_residency=xr,
        )


def full_space(
    formats: Sequence[str] | None = None, **schedule_kw
) -> Iterator[TuningConfig]:
    """The run-time-mode space: format x schedule.

    ``formats`` defaults to every *registered* format (including plugins
    registered via ``repro_torch.sparse.registry.register_format``)."""
    for fmt in format_names() if formats is None else formats:
        for sched in schedule_space(**schedule_kw):
            yield TuningConfig(fmt, sched)


def compile_time_space(**schedule_kw) -> Iterator[TuningConfig]:
    """The compile-time-mode space: the default (held) format fixed
    (paper §5.2 step 3 — CSR), schedule free."""
    return full_space(formats=(default_format(),), **schedule_kw)


def knob_value(config: TuningConfig, knob: str):
    field, _ = KNOBS[knob]
    return getattr(config.schedule, field)


def space_size(**kw) -> int:
    return sum(1 for _ in full_space(**kw))


# --- the card's space ---------------------------------------------------------

# the knobs that reach a launch parameter of B1 on the card (the paper's
# three and the precision): tb_size -> rows per row CTA, maxrregcount ->
# accumulators per lane (the UNROLL template, and so the registers), memory
# -> the SM's L1 / shared-memory split. nnz_tile reaches no CSR parameter.
CARD_KNOBS = ("tb_size", "maxrregcount", "memory", "accum_dtype")


def representative_order(config: TuningConfig) -> tuple:
    """Sort key that picks a launch's representative among the schedules
    that give it: the reference default's value in each field the kernel
    does not read, else the smallest."""
    s, d = config.schedule, DEFAULT_SCHEDULE
    return (s.rows_per_block != d.rows_per_block, s.rows_per_block,
            s.nnz_tile != d.nnz_tile, s.nnz_tile, s.unroll != d.unroll, s.unroll,
            s.accum_dtype != d.accum_dtype, s.x_residency != d.x_residency,
            s.dimension_semantics != d.dimension_semantics)


def tie_order(config: TuningConfig) -> tuple:
    """Sort key that breaks ties between measured points: the held format,
    the default schedule, then fewer rows per block, fewer accumulators,
    float32, the smaller nnz_tile, ``"vmem"``."""
    s, d = config.schedule, DEFAULT_SCHEDULE
    return (config.fmt != default_format(), s != d, s.rows_per_block, s.unroll,
            s.accum_dtype != "float32", s.nnz_tile, s.x_residency != "vmem")


@dataclass(frozen=True)
class CardSpace:
    """The tuning space as the card runs it, per matrix.

    For each format (``None``: every registered one) the schedules of
    ``schedule_space()`` are grouped by ``FormatSpec.card_launch``: one
    point per distinct (storage geometry, launch), the group's
    ``representative_order`` minimum standing for it. A format without
    ``card_launch`` keeps every schedule. ``n_sms`` is the card's SM count
    the launch plans are made for (132: an H100 SXM).
    """

    formats: tuple[str, ...] | None = None
    n_sms: int = H100_SMS

    def launch(self, stats, config: TuningConfig) -> CardLaunch:
        """What ``config`` is on the card for the matrix of ``stats``."""
        spec = get_format(config.fmt)
        if spec.card_launch is None:
            return CardLaunch(config.schedule, None)
        return spec.card_launch(stats, config.schedule, self.n_sms)

    def groups(self, stats) -> dict[tuple[str, Hashable, Hashable], list[TuningConfig]]:
        """(format, geometry, launch) -> the configs that give it, in space order."""
        out: dict = {}
        for fmt in format_names() if self.formats is None else self.formats:
            for sched in schedule_space():
                cfg = TuningConfig(fmt, sched)
                at = self.launch(stats, cfg)
                out.setdefault((fmt, at.geometry, at.launch), []).append(cfg)
        return out

    def points(self, stats) -> list[TuningConfig]:
        """One config per distinct launch: each group's representative."""
        return [min(g, key=representative_order) for g in self.groups(stats).values()]

    def point_of(self, stats, config: TuningConfig) -> TuningConfig:
        """The point of this space that gives ``config``'s launch."""
        at = self.launch(stats, config)
        group = self.groups(stats).get((config.fmt, at.geometry, at.launch))
        if group is None:
            raise ValueError(f"{config} is outside the card's space")
        return min(group, key=representative_order)


def card_compile_time_space(n_sms: int = H100_SMS) -> CardSpace:
    """The card's compile-time space: the held format only."""
    return CardSpace((default_format(),), n_sms)

