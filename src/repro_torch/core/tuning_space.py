"""The Auto-SpMV configuration space (format x compile-time schedule).

``KNOBS`` maps each of the paper's tunable parameters to its field on
``KernelSchedule`` (see ``kernels/common.py`` for what each steers on the
card): ``tb_size`` -> rows_per_block, ``maxrregcount`` -> unroll, ``memory``
-> x_residency; ``nnz_tile`` and ``accum_dtype`` are extras beyond the
paper's three, reported separately.

The paper's *default* configuration (its comparison baseline) is the CSR
format with untuned compiler parameters; ours is CSR with the default
schedule.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterator, Sequence

from repro_torch.kernels.common import (
    ACCUM_DTYPE_CHOICES,
    DEFAULT_SCHEDULE,
    NNZ_TILE_CHOICES,
    ROWS_PER_BLOCK_CHOICES,
    UNROLL_CHOICES,
    X_RESIDENCY_CHOICES,
    KernelSchedule,
)
from repro_torch.sparse.registry import default_format, format_names


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
