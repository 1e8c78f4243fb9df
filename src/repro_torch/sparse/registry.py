"""Pluggable sparse-format registry: one ``FormatSpec`` from converter to
bandit arm.

Historically every layer of the reproduction hard-coded the four seed
formats: ``if fmt == "csr"`` chains in the kernel wrapper, per-format
footprint branches in the cost model, ``FORMAT_NAMES`` literals in the
tuning space, and ``"csr"`` defaults through session / predictor / bandit /
serve CLI. The SpMV literature catalogues dozens of formats (Gao et al.,
arXiv:2404.06047; Koza et al.'s CMRS, arXiv:1203.2946), so format count must
be a *runtime* property: this module defines the ``FormatSpec`` contract
that bundles everything the system branches on per format, and every
dispatch site consumes the registry instead of a literal.

Adding a format is one call::

    from repro_torch.sparse.registry import FormatSpec, register_format

    register_format(FormatSpec(
        name="myfmt",
        container=MyFmt,            # frozen dataclass of tensors
        from_dense=myfmt_from_dense,
        to_dense=myfmt_to_dense,
        prepare=my_prepare,         # (dense, schedule, *, device) -> MyFmt, aligned
        spmv=my_spmv,               # (mat, x, schedule) -> y
        reference=my_reference,     # plain-torch oracle, (mat, x) -> y
        footprint=my_footprint,     # (MatrixStats, schedule) -> KernelFootprint
    ))

and the format then appears in ``full_space()``, the tuning dataset,
classifier labels, the serving bandit's arm set, and the SpMV server —
no edits to any of those layers. the blocked-CSR plugin of the reference package (a fifth format registered
exactly this way) is ported in a later slice.

Contract notes for plugin authors (enforced by the shared suite in
``tests/test_format_registry.py``):

* ``from_dense``/``to_dense`` must round-trip exactly;
* ``prepare`` aligns storage geometry to the ``KernelSchedule`` and raises
  ``InfeasibleConfig`` when storage would blow up (``check_storage_bytes``);
* ``spmv`` on storage prepared with a *different* schedule must either
  compute the exact result or raise ``InfeasibleConfig`` — never silently
  corrupt;
* ``footprint`` must return finite, non-negative statistics with
  ``useful_flops == 2 * nnz``;
* ``card_launch`` (optional) says, from integers only, what a schedule
  becomes on the card: the storage geometry ``prepare`` builds, the launch
  its kernel makes on it (the plan plus the schedule fields the kernel
  reads), and whether ``prepare`` admits it. The card's tuning space
  (``repro_torch.core.tuning_space.CardSpace``) keeps one point per
  distinct (geometry, launch); a format without it keeps every schedule.
* ``card_work`` (optional) counts, from the same integer plans, what that
  launch does on the card (``CardWork``): bytes moved, products, x
  gathers, CTAs, and the serial steps of its busiest CTAs; the card's cost
  model (``core.objectives.CardCostModel``) prices them.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Hashable, NamedTuple

import numpy as np
import torch

from repro_torch.kernels.common import (
    BLOCK_CTAS_PER_SM,
    FAST_MEMORY_BYTES,
    LANE,
    InfeasibleConfig,
    KernelSchedule,
    block_segments,
    ceil_to,
    pad_axis,
    resolve_device,
)

__all__ = [
    "CardLaunch",
    "CardWork",
    "FormatSpec",
    "InfeasibleConfig",
    "KernelFootprint",
    "MatrixStats",
    "MAX_STORAGE_BYTES",
    "check_storage_bytes",
    "default_format",
    "format_names",
    "get_format",
    "register_format",
    "registered_specs",
    "spec_for",
    "unregister_format",
]

MAX_STORAGE_BYTES = 512 * 1024 * 1024  # refuse >512 MiB single-format storage


def check_storage_bytes(estimate: int, what: str) -> None:
    """Shared feasibility guard for ``FormatSpec.prepare`` implementations."""
    if estimate > MAX_STORAGE_BYTES:
        raise InfeasibleConfig(f"{what} storage would be {estimate/1e6:.0f} MB")


# ---------------------------------------------------------------------------
# Matrix statistics + footprint model (the cost model's per-format inputs)
# ---------------------------------------------------------------------------


class MatrixStats:
    """Cached structural statistics of one matrix (host-side numpy).

    The duck-typed interface ``FormatSpec.footprint`` implementations rely
    on: ``n_rows``, ``n_cols``, ``nnz``, ``max_nnz``, ``row_counts``, plus
    the cached ``block_occupancy(br, bc)`` and ``sell_storage(C, q)``
    reductions.
    """

    def __init__(self, dense: np.ndarray):
        dense = np.asarray(dense)
        self.n_rows, self.n_cols = dense.shape
        self._mask = dense != 0
        self.row_counts = np.count_nonzero(self._mask, axis=1).astype(np.int64)
        self.nnz = int(self.row_counts.sum())
        self.max_nnz = int(self.row_counts.max(initial=0))

    @lru_cache(maxsize=16)
    def block_occupancy(self, br: int, bc: int) -> tuple[int, int]:
        """(#occupied blocks, max occupied blocks per block-row)."""
        if self.n_rows == 0 or self.n_cols == 0:
            return 0, 0
        occ = np.logical_or.reduceat(self._column_blocks(bc), np.arange(0, self.n_rows, br),
                                     axis=0)
        per_row = occ.sum(axis=1)
        return int(occ.sum()), int(per_row.max(initial=0))

    @lru_cache(maxsize=4)
    def _column_blocks(self, bc: int) -> np.ndarray:
        # each row's occupied column blocks: one scan of the mask serves
        # every block height
        return np.logical_or.reduceat(self._mask, np.arange(0, self.n_cols, bc), axis=1)

    @lru_cache(maxsize=16)
    def sell_storage(self, C: int, q: int) -> tuple[int, int]:
        """(total stored elems, max width) for SELL-C-q."""
        n_slices = (self.n_rows + C - 1) // C
        total, maxw = 0, 0
        for s in range(n_slices):
            w = int(self.row_counts[s * C : (s + 1) * C].max(initial=0))
            w = ceil_to(max(w, 1), q)
            total += w * C
            maxw = max(maxw, w)
        return total, maxw


@dataclass(frozen=True)
class KernelFootprint:
    """Work/traffic summary of one (matrix, format, schedule) point."""

    useful_flops: float
    total_flops: float  # includes padding compute
    hbm_bytes: float  # format storage + X + Y traffic
    gather_elems: float  # in-kernel dynamic gathers
    scatter_elems: float  # in-kernel scatter-adds
    grid_steps: float
    mxu_fraction: float  # fraction of FLOPs in dense block products
    vmem_resident_bytes: float  # steady-state fast-memory working set
    feasible: bool
    note: str = ""


class CardLaunch(NamedTuple):
    """What one (matrix, format, schedule) point is on the card: the storage
    ``prepare`` builds (``geometry``), the launch its kernel makes on that
    storage (``launch``: the launch plan and the schedule fields the kernel
    reads), and whether ``prepare`` admits the storage (``feasible``; its
    guard refuses what ``check_storage_bytes`` refuses)."""

    geometry: Hashable
    launch: Hashable
    feasible: bool = True


def _plan_key(plan: dict) -> tuple:
    return tuple(sorted(plan.items()))


class CardWork(NamedTuple):
    """What one launch does on the card, from integers (``card_work``).

    ``bytes``: device-memory bytes it moves (what it reads of the storage,
    up to the padding tail where the kernel stops, the index arrays it
    walks, x once and y once); ``flops``: twice the products it computes
    (BELL computes its blocks whole); ``gathers``: x elements it gathers;
    ``ctas``: CTAs launched. ``steps``: the serial trips of the launch's
    busiest CTAs, a makespan: the larger of the CTAs' trips spread over
    every CTA slot of the card and the longest CTA's (a trip is one round
    of a lane's loads and gathers: B1 a warp's ``32 x unroll`` nonzeros,
    B2 a row group's ``G x unroll`` slots, B3 ``P x unroll`` elements of a
    row, B4 one ``br x 128`` block per ``br / 8`` of its rows); ``rows``:
    the same makespan of the rows the CTAs' warps walk one after another
    (B1 only: each costs an ``indptr`` read, a shuffle tree and a store).
    ``unroll``: a lane's accumulators (the loads a trip issues; B4: 1);
    ``bf16`` and ``stream`` flag the accumulator and B1's carveout."""

    bytes: float
    flops: float
    gathers: float
    ctas: int
    steps: float
    rows: float = 0.0
    unroll: int = 1
    bf16: bool = False
    stream: bool = False


# CTAs an SM holds of a 256-thread CTA (B1, B2): 2,048 threads
_CTAS_PER_SM_256 = 8


def _makespan(per_cta: np.ndarray, slots: int) -> float:
    """Serial work of a launch whose CTAs run ``per_cta`` each on ``slots``
    CTA slots: the larger of the spread sum and the longest CTA."""
    if per_cta.size == 0:
        return 0.0
    return float(max(per_cta.sum() / slots, per_cta.max()))


# ---------------------------------------------------------------------------
# The FormatSpec contract + registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FormatSpec:
    """Everything the system needs to know about one sparse format.

    ``priority`` orders ``format_names()`` and picks ``default_format()``
    (lowest wins); plugins default to 100 so they never displace the seed
    default unless they ask to.
    """

    name: str
    container: type  # the storage dataclass (tensor fields)
    from_dense: Callable  # (dense, **kw) -> container
    to_dense: Callable  # (mat) -> np.ndarray (exact inverse)
    prepare: Callable  # (dense, KernelSchedule, *, device) -> container, aligned
    spmv: Callable  # (mat, x, KernelSchedule) -> y, on the container's device
    reference: Callable  # (mat, x) -> y — plain-torch oracle
    footprint: Callable  # (MatrixStats, KernelSchedule) -> KernelFootprint
    priority: int = 100
    description: str = ""
    # (MatrixStats, KernelSchedule, n_sms) -> CardLaunch; None: every
    # schedule is its own point of the card's space
    card_launch: Callable | None = None
    # (MatrixStats, KernelSchedule, n_sms) -> CardWork; None: the card's
    # cost model (core.objectives.CardCostModel) cannot price the format
    card_work: Callable | None = None


_REGISTRY: dict[str, FormatSpec] = {}
_BY_CONTAINER: dict[type, FormatSpec] = {}
_INSERTION: dict[str, int] = {}
_counter = 0


def register_format(spec: FormatSpec, *, overwrite: bool = False) -> FormatSpec:
    """Register ``spec``; after this call the format is live everywhere
    (tuning space, dataset harness, cost model, bandit arms, serving)."""
    global _counter
    if not spec.name or not spec.name.isidentifier():
        raise ValueError(f"format name must be an identifier, got {spec.name!r}")
    if spec.name in _REGISTRY and not overwrite:
        raise ValueError(
            f"format {spec.name!r} already registered; pass overwrite=True"
        )
    bound = _BY_CONTAINER.get(spec.container)
    if bound is not None and bound.name != spec.name:
        raise ValueError(
            f"container {spec.container.__name__} already bound to format "
            f"{bound.name!r}"
        )
    prev = _REGISTRY.get(spec.name)
    if prev is not None:
        _BY_CONTAINER.pop(prev.container, None)
        _evict_prepared_kernels(spec.name)
    _REGISTRY[spec.name] = spec
    _BY_CONTAINER[spec.container] = spec
    if spec.name not in _INSERTION:
        _INSERTION[spec.name] = _counter
        _counter += 1
    return spec


def unregister_format(name: str) -> None:
    spec = _REGISTRY.pop(name, None)
    if spec is None:
        raise ValueError(f"format {name!r} is not registered")
    _BY_CONTAINER.pop(spec.container, None)
    _INSERTION.pop(name, None)
    _evict_prepared_kernels(name)


def _evict_prepared_kernels(name: str) -> None:
    """A memoized ``PreparedSpmv`` must not outlive the spec that built it."""
    from repro_torch.kernels.ops import evict_kernel_memo_format

    evict_kernel_memo_format(name)


def get_format(name: str) -> FormatSpec:
    spec = _REGISTRY.get(name)
    if spec is None:
        raise ValueError(
            f"unknown format {name!r}; registered formats: {format_names()}"
        )
    return spec


def format_names() -> tuple[str, ...]:
    """Registered format names, ordered by (priority, registration order)."""
    return tuple(
        sorted(_REGISTRY, key=lambda n: (_REGISTRY[n].priority, _INSERTION[n]))
    )


def default_format() -> str:
    """The format the system holds/serves when nothing better is known."""
    names = format_names()
    if not names:
        raise RuntimeError("no sparse formats registered")
    return names[0]


def registered_specs() -> tuple[FormatSpec, ...]:
    return tuple(_REGISTRY[n] for n in format_names())


def spec_for(mat) -> FormatSpec:
    """Resolve the spec governing a storage container instance."""
    spec = _BY_CONTAINER.get(type(mat))
    if spec is None:
        raise TypeError(
            f"no registered format for container {type(mat).__name__}; "
            f"registered: {format_names()}"
        )
    return spec


# ---------------------------------------------------------------------------
# Seed formats: CSR / ELL / BELL / SELL
#
# Everything below is ordinary plugin code — it uses only the public
# machinery above, exactly as third-party formats do. The kernel entrypoints
# are imported here (after the machinery is defined) so that the
# kernels <-> sparse import cycle resolves cleanly in either direction.
# ---------------------------------------------------------------------------

from repro_torch.kernels.bell import bell_spmv  # noqa: E402
from repro_torch.kernels.csr import csr_launch_plan, csr_spmv  # noqa: E402
from repro_torch.kernels.ell import ell_launch_plan, ell_spmv  # noqa: E402
from repro_torch.kernels.sell import sell_launch_plan, sell_spmv  # noqa: E402
from repro_torch.sparse.formats import (  # noqa: E402
    BELL,
    CSR,
    ELL,
    SELL,
    to_tensor,
    bell_from_dense,
    bell_occupancy,
    bell_to_dense,
    csr_from_dense,
    csr_to_dense,
    ell_from_dense,
    ell_to_dense,
    row_counts,
    sell_from_dense,
    sell_to_dense,
)
from repro_torch.sparse.spmv import (  # noqa: E402  (plain-torch oracles)
    spmv_bell as _ref_bell,
    spmv_csr as _ref_csr,
    spmv_ell as _ref_ell,
    spmv_sell as _ref_sell,
)

_VAL_B, _IDX_B = 4.0, 4.0  # fp32 values, int32 indices


def _as_x(x, like: torch.Tensor) -> torch.Tensor:
    """x as a contiguous float32 vector on the container's device."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device).contiguous()


# --- CSR -------------------------------------------------------------------


def _csr_prepare(dense: np.ndarray, schedule: KernelSchedule, *, device=None) -> CSR:
    return csr_from_dense(np.asarray(dense), device=device)


def _csr_spmv(mat: CSR, x, schedule: KernelSchedule):
    # the kernel walks indptr and needs no tile padding: the arrays go to it
    # as stored, with no per-call host round trip
    return csr_spmv(mat.data, mat.indices, mat.indptr, _as_x(x, mat.data), schedule)


def _csr_footprint(stats: MatrixStats, schedule: KernelSchedule) -> KernelFootprint:
    n, m, nnz = stats.n_rows, stats.n_cols, stats.nnz
    nt = schedule.nnz_tile
    x_bytes, y_bytes = m * _VAL_B, n * _VAL_B
    nnz_pad = ceil_to(max(nnz, 1), nt)
    stored = float(nnz_pad)
    # data + cols + row_ids + indptr + x + y
    hbm = stored * (_VAL_B + 2 * _IDX_B) + (n + 1) * _IDX_B + x_bytes + y_bytes
    steps = nnz_pad / nt
    tile_b = nt * (_VAL_B + 2 * _IDX_B)
    vmem = 2 * tile_b + x_bytes + (n + 1) * _VAL_B  # y resident too
    return KernelFootprint(
        2.0 * nnz, 2 * stored, hbm, stored, stored, steps, 0.0, vmem,
        vmem <= FAST_MEMORY_BYTES and schedule.x_residency == "vmem",
        note="" if schedule.x_residency == "vmem"
        else "the CSR kernel reads x through the cached path only",
    )


def _csr_card_launch(stats: MatrixStats, schedule: KernelSchedule, n_sms: int) -> CardLaunch:
    # the storage is the matrix's own; B1 reads rows_per_block, unroll (its
    # plan), accum_dtype and x_residency (the L1 / shared split), not nnz_tile
    plan = csr_launch_plan(stats.n_rows, stats.nnz, schedule.rows_per_block,
                           schedule.unroll, n_sms, n_cols=stats.n_cols)
    return CardLaunch((stats.n_rows, stats.n_cols, stats.nnz),
                      (_plan_key(plan), schedule.accum_dtype, schedule.x_residency))


def _csr_card_work(stats: MatrixStats, schedule: KernelSchedule, n_sms: int) -> CardWork:
    # B1: row CTAs of rows_per_block rows, warp k of a CTA takes rows k, k +
    # 8, ...; a row of more than hub_row nonzeros goes to the chunk CTAs,
    # each of which adds the hub nonzeros of its chunk with all its threads
    n, nnz = stats.n_rows, stats.nnz
    plan = csr_launch_plan(n, nnz, schedule.rows_per_block, schedule.unroll, n_sms,
                           n_cols=stats.n_cols)
    lens = stats.row_counts
    hub = lens > plan["hub_row"]
    trips = np.where(hub, 0, -(-lens // (32 * schedule.unroll)))
    rpb, warps = plan["rows_per_cta"], plan["threads"] // 32
    padded = np.zeros(plan["row_ctas"] * rpb, dtype=np.int64)
    padded[:n] = trips
    per_warp = padded.reshape(plan["row_ctas"], rpb // warps, warps).sum(axis=1)
    per_cta = per_warp.max(axis=1) if per_warp.size else per_warp.reshape(-1)
    if plan["hub_ctas"]:
        hub_trips = -(-int(lens[hub].sum()) // (plan["hub_ctas"] * plan["threads"]))
        per_cta = np.concatenate([np.full(plan["hub_ctas"], hub_trips), per_cta])
    slots = n_sms * _CTAS_PER_SM_256
    rows = np.full(plan["row_ctas"], rpb // warps)
    return CardWork(
        bytes=float(nnz * (_VAL_B + _IDX_B) + (n + 1) * _IDX_B + n * _VAL_B
                    + stats.n_cols * _VAL_B),
        flops=2.0 * nnz, gathers=float(nnz), ctas=plan["ctas"],
        steps=_makespan(per_cta, slots), rows=_makespan(rows, slots), unroll=schedule.unroll,
        bf16=schedule.accum_dtype == "bfloat16", stream=schedule.x_residency == "stream")


# --- ELL -------------------------------------------------------------------


def _ell_prepare(dense: np.ndarray, schedule: KernelSchedule, *, device=None) -> ELL:
    device = resolve_device(device)
    dense = np.asarray(dense)
    n_rows, _ = dense.shape
    rpb, nt = schedule.rows_per_block, schedule.nnz_tile
    counts_max = int(row_counts(dense).max(initial=0))
    width = ceil_to(max(counts_max, 1), nt)
    check_storage_bytes(ceil_to(n_rows, rpb) * width * 8, "ELL")
    mat = ell_from_dense(dense, min_width=width, device="cpu")
    data = pad_axis(mat.data.numpy(), 0, ceil_to(n_rows, rpb))
    cols = pad_axis(mat.cols.numpy(), 0, ceil_to(n_rows, rpb))
    return ELL(to_tensor(data, device), to_tensor(cols, device), shape=mat.shape)


def _ell_spmv(mat: ELL, x, schedule: KernelSchedule):
    n_rows, _ = mat.shape
    rpb, nt = schedule.rows_per_block, schedule.nnz_tile
    R, W = mat.data.shape
    if R % rpb or W % nt:
        raise InfeasibleConfig(
            f"ELL planes ({R},{W}) not aligned to schedule ({rpb},{nt}); "
            "use prepare() with the same schedule"
        )
    y = ell_spmv(mat.data, mat.cols, _as_x(x, mat.data), schedule)
    return y[:n_rows]


def _ell_footprint(stats: MatrixStats, schedule: KernelSchedule) -> KernelFootprint:
    n, m, nnz = stats.n_rows, stats.n_cols, stats.nnz
    rpb, nt = schedule.rows_per_block, schedule.nnz_tile
    x_bytes, y_bytes = m * _VAL_B, n * _VAL_B
    width = ceil_to(max(stats.max_nnz, 1), nt)
    rows = ceil_to(n, rpb)
    stored = float(rows) * width
    hbm = stored * (_VAL_B + _IDX_B) + x_bytes + y_bytes
    steps = (rows / rpb) * (width / nt)
    tile_b = rpb * nt * (_VAL_B + _IDX_B)
    vmem = 2 * tile_b + (x_bytes if schedule.x_residency == "vmem" else 0) + rpb * _VAL_B
    return KernelFootprint(
        2.0 * nnz, 2 * stored, hbm, stored, 0.0, steps, 0.0, vmem,
        vmem <= FAST_MEMORY_BYTES and schedule.x_residency == "vmem",
        note="" if schedule.x_residency == "vmem"
        else "the ELL kernel reads x through the cached path only",
    )


def _ell_card_launch(stats: MatrixStats, schedule: KernelSchedule, n_sms: int) -> CardLaunch:
    # planes (R, W) as _ell_prepare aligns them; B2's plan follows (R, W), and
    # it reads unroll and accum_dtype
    R = ceil_to(stats.n_rows, schedule.rows_per_block)
    W = ceil_to(max(stats.max_nnz, 1), schedule.nnz_tile)
    return CardLaunch((R, W), (_plan_key(ell_launch_plan(R, W, n_sms)), schedule.unroll,
                               schedule.accum_dtype), R * W * 8 <= MAX_STORAGE_BYTES)


def _ell_card_work(stats: MatrixStats, schedule: KernelSchedule, n_sms: int) -> CardWork:
    # B2: a group of G lanes per row, 32 / G rows a warp, 8 warps a CTA; a
    # row's group reads steps of G x unroll slots and stops after the step
    # that holds its first padding slot; a warp runs its slowest row's steps
    R = ceil_to(stats.n_rows, schedule.rows_per_block)
    W = ceil_to(max(stats.max_nnz, 1), schedule.nnz_tile)
    plan = ell_launch_plan(R, W, n_sms)
    step = plan["lanes"] * schedule.unroll
    lens = np.zeros(plan["ctas"] * plan["rows_per_cta"], dtype=np.int64)
    lens[: stats.n_rows] = stats.row_counts
    row_steps = np.minimum(-(-W // step), lens // step + 1)
    row_steps[R:] = 0
    per_cta = row_steps.reshape(plan["ctas"], -1).max(axis=1)
    slots = int(np.minimum(W, row_steps * step).sum())
    return CardWork(
        bytes=float(slots * (_VAL_B + _IDX_B) + stats.n_cols * _VAL_B + R * _VAL_B),
        flops=2.0 * stats.nnz, gathers=float(stats.nnz), ctas=plan["ctas"],
        steps=_makespan(per_cta, n_sms * _CTAS_PER_SM_256), unroll=schedule.unroll,
        bf16=schedule.accum_dtype == "bfloat16")


# --- BELL ------------------------------------------------------------------


def _bell_bytes(nbr: int, max_blocks: int, br: int) -> int:
    # what bell_from_dense stores: nbr x max_blocks blocks of br x 128 slots,
    # 8 bytes a slot as the other formats' guards count
    return nbr * max(max_blocks, 1) * br * LANE * 8


def _bell_prepare(dense: np.ndarray, schedule: KernelSchedule, *, device=None) -> BELL:
    # The guard charges the storage bell_from_dense builds. The reference
    # charges min(nnz, nbr x n_col_blocks) blocks as if every block row held
    # that many, which refuses every BELL above n ~ 8,000 (a stated
    # difference: its bound stays 512 MiB, what it bounds is the true size).
    # One scan serves the guard and the converter. _bell_card_launch counts
    # blocks from MatrixStats's mask of the values before the cast, so it
    # charges at least this (more only where a nonzero rounds to 0 in
    # float32): what it calls feasible, this admits.
    dense = np.asarray(dense)
    br = min(schedule.rows_per_block, 256)
    nbr = ceil_to(dense.shape[0], br) // br
    occupancy = bell_occupancy(dense, br, LANE)
    check_storage_bytes(_bell_bytes(nbr, occupancy.max_blocks, br), "BELL")
    return bell_from_dense(dense, br=br, bc=LANE, device=device, occupancy=occupancy)


def _bell_spmv(mat: BELL, x, schedule: KernelSchedule):
    n_rows, n_cols = mat.shape
    x = _as_x(x, mat.data)
    xp = torch.zeros(ceil_to(n_cols, mat.bc), dtype=x.dtype, device=x.device)
    xp[:n_cols] = x
    x_panels = xp.reshape(-1, mat.bc)
    y = bell_spmv(mat.data, mat.block_cols, x_panels, schedule)
    return y.reshape(-1)[:n_rows]


def _bell_footprint(stats: MatrixStats, schedule: KernelSchedule) -> KernelFootprint:
    n, m, nnz = stats.n_rows, stats.n_cols, stats.nnz
    x_bytes, y_bytes = m * _VAL_B, n * _VAL_B
    br, bc = min(schedule.rows_per_block, 256), LANE
    n_blocks, max_blocks = stats.block_occupancy(br, bc)
    nbr = ceil_to(n, br) // br
    stored_blocks = float(nbr) * max(max_blocks, 1)
    stored = stored_blocks * br * bc
    x_traffic = (
        stored_blocks * bc * _VAL_B  # one x panel fetched per stored block
        if schedule.x_residency == "stream"
        else x_bytes
    )
    hbm = stored * _VAL_B + stored_blocks * _IDX_B + x_traffic + y_bytes
    steps = stored_blocks
    tile_b = br * bc * _VAL_B + bc * _VAL_B
    vmem = 2 * tile_b + br * _VAL_B + (x_bytes if schedule.x_residency == "vmem" else 0)
    return KernelFootprint(
        2.0 * nnz, 2 * stored, hbm, 0.0, 0.0, steps, 1.0, vmem,
        vmem <= FAST_MEMORY_BYTES,
    )


def _bell_card_launch(stats: MatrixStats, schedule: KernelSchedule, n_sms: int) -> CardLaunch:
    # blocks of br x 128 as _bell_prepare builds them (its guard too); B4
    # takes its segments from the shapes and reads accum_dtype only
    br = min(schedule.rows_per_block, 256)
    nbr = ceil_to(stats.n_rows, br) // br
    mb = max(stats.block_occupancy(br, LANE)[1], 1)
    return CardLaunch((br, nbr, mb), (block_segments(nbr, mb, n_sms), schedule.accum_dtype),
                      _bell_bytes(nbr, mb, br) <= MAX_STORAGE_BYTES)


def _bell_card_work(stats: MatrixStats, schedule: KernelSchedule, n_sms: int) -> CardWork:
    # B4: S segments of each block row's live blocks, a CTA each, two CTAs
    # an SM; a block moves br x 128 values and its x panel
    br = min(schedule.rows_per_block, 256)
    nbr = ceil_to(stats.n_rows, br) // br
    blocks, mb = stats.block_occupancy(br, LANE)
    S = block_segments(nbr, max(mb, 1), n_sms)
    longest = -(-max(mb, 1) // S)  # blocks of the busiest segment
    steps = max(blocks / (n_sms * BLOCK_CTAS_PER_SM), longest) * br / 8
    return CardWork(
        bytes=float(blocks * (br * LANE * _VAL_B + _IDX_B) + stats.n_cols * _VAL_B
                    + nbr * br * _VAL_B),
        flops=2.0 * blocks * br * LANE, gathers=float(blocks * LANE), ctas=nbr * S,
        steps=steps, bf16=schedule.accum_dtype == "bfloat16")


# --- SELL ------------------------------------------------------------------


def _sell_prepare(dense: np.ndarray, schedule: KernelSchedule, *, device=None) -> SELL:
    return sell_from_dense(
        np.asarray(dense), C=schedule.rows_per_block, q=schedule.nnz_tile, device=device
    )


# nnz_tile values each SELL container's storage has been checked against:
# the check reads slice_ptr/slice_width on the host, so it runs once per
# (container, nnz_tile) instead of forcing a device-to-host copy per SpMV
_SELL_ALIGNMENT: "weakref.WeakKeyDictionary[SELL, dict[int, bool]]" = (
    weakref.WeakKeyDictionary()
)


def _sell_aligned(mat: SELL, nt: int) -> bool:
    seen = _SELL_ALIGNMENT.setdefault(mat, {})
    ok = seen.get(nt)
    if ok is None:
        blk = nt * mat.C
        sp = mat.slice_ptr.cpu().numpy()
        sw = mat.slice_width.cpu().numpy()
        ok = seen[nt] = not (
            mat.data.shape[0] % blk or (sp % blk).any() or (sw % nt).any()
        )
    return ok


def _sell_spmv(mat: SELL, x, schedule: KernelSchedule):
    n_rows, _ = mat.shape
    nt = schedule.nnz_tile
    if not _sell_aligned(mat, nt):
        raise InfeasibleConfig(
            f"SELL storage quantum mismatch with nnz_tile={nt}; "
            "convert with prepare(..., schedule) so widths are nt-aligned"
        )
    y = sell_spmv(
        mat.data, mat.cols, mat.slice_ptr, mat.slice_width,
        _as_x(x, mat.data), mat.C, schedule,
    )
    return y.reshape(-1)[:n_rows]


def _sell_footprint(stats: MatrixStats, schedule: KernelSchedule) -> KernelFootprint:
    n, m, nnz = stats.n_rows, stats.n_cols, stats.nnz
    rpb, nt = schedule.rows_per_block, schedule.nnz_tile
    x_bytes, y_bytes = m * _VAL_B, n * _VAL_B
    C = rpb
    total, maxw = stats.sell_storage(C, nt)
    n_slices = (n + C - 1) // C
    stored = float(total)
    hbm = stored * (_VAL_B + _IDX_B) + x_bytes + y_bytes
    steps = n_slices * (maxw / nt)  # kept as the reference counts it
    tile_b = nt * C * (_VAL_B + _IDX_B)
    vmem = 2 * tile_b + (x_bytes if schedule.x_residency == "vmem" else 0) + C * _VAL_B
    return KernelFootprint(
        2.0 * nnz, 2 * stored, hbm, stored, 0.0, steps, 0.0, vmem,
        vmem <= FAST_MEMORY_BYTES and schedule.x_residency == "vmem",
        note="" if schedule.x_residency == "vmem"
        else "the SELL kernel reads x through the cached path only",
    )


def _sell_card_launch(stats: MatrixStats, schedule: KernelSchedule, n_sms: int) -> CardLaunch:
    # slices of C = rows_per_block rows, widths rounded up to nnz_tile: at
    # one C the stored total fixes every width (each nnz_tile divides the
    # next); B3's plan follows them, and it reads unroll and accum_dtype
    C = schedule.rows_per_block
    total, widest = stats.sell_storage(C, schedule.nnz_tile)
    n_slices = -(-stats.n_rows // C)
    plan = sell_launch_plan(n_slices, C, total / max(n_slices * C, 1), n_sms)
    return CardLaunch((C, total, widest),
                      (_plan_key(plan), schedule.unroll, schedule.accum_dtype))


@lru_cache(maxsize=1)
def _sell_threads(stats: MatrixStats, C: int, q: int, n_sms: int):
    # B3's plan at slices of C rows and widths rounded up to q, and per
    # thread its slice's width and its row's length (the work of each
    # unroll reads them; the card model walks one (C, q)'s unrolls in turn)
    total, _ = stats.sell_storage(C, q)
    n_slices = -(-stats.n_rows // C)
    plan = sell_launch_plan(n_slices, C, total / max(n_slices * C, 1), n_sms)
    P, spc, threads = plan["row_threads"], plan["slices_per_cta"], plan["threads"]
    lens = np.zeros(n_slices * C, dtype=np.int64)
    lens[: stats.n_rows] = stats.row_counts
    widths = -(-np.maximum(lens.reshape(n_slices, C).max(axis=1), 1) // q) * q
    t = np.arange(plan["ctas"] * threads)
    local = t % threads
    sl = (t // threads) * spc + local // (P * C)
    ok = (local < spc * P * C) & (sl < n_slices)
    sl = np.where(ok, sl, 0)
    p, r = (local % (P * C)) // C, local % C
    width = np.where(ok, widths[sl], 0)
    live = np.where(ok, lens[sl * C + r], 0)
    return plan, n_slices, p, ok, width, live


def _sell_card_work(stats: MatrixStats, schedule: KernelSchedule, n_sms: int) -> CardWork:
    # B3: thread p * C + r of a slice takes row r's elements p, p + P, ...
    # in steps of P x unroll; a warp stops after the first step at which
    # every thread's last element is padding, or at its slices' widest
    C, U = schedule.rows_per_block, schedule.unroll
    plan, n_slices, p, ok, width, live = _sell_threads(stats, C, schedule.nnz_tile, n_sms)
    P, threads = plan["row_threads"], plan["threads"]
    step = P * U
    own = np.maximum((live - (U - 1) * P - p + step - 1) // step, 0) + 1
    warp_steps = np.minimum(own.reshape(-1, 32).max(axis=1),
                            -(-width.reshape(-1, 32).max(axis=1) // step))
    reach = np.minimum(width, np.repeat(warp_steps, 32) * step)
    read = int(np.maximum(-(-(reach - p) // P), 0)[ok].sum())
    per_cta = warp_steps.reshape(plan["ctas"], -1).max(axis=1)
    return CardWork(
        bytes=float(read * (_VAL_B + _IDX_B) + 2 * n_slices * _IDX_B
                    + stats.n_cols * _VAL_B + n_slices * C * _VAL_B),
        flops=2.0 * stats.nnz, gathers=float(stats.nnz), ctas=plan["ctas"],
        steps=_makespan(per_cta, n_sms * max(1, min(32, 2048 // threads))),
        unroll=U, bf16=schedule.accum_dtype == "bfloat16")


register_format(FormatSpec(
    name="csr",
    container=CSR,
    from_dense=csr_from_dense,
    to_dense=csr_to_dense,
    prepare=_csr_prepare,
    spmv=_csr_spmv,
    reference=_ref_csr,
    footprint=_csr_footprint,
    card_launch=_csr_card_launch,
    card_work=_csr_card_work,
    priority=0,
    description="Compressed Sparse Row (warp per row; hub rows split over nonzero chunks)",
))
register_format(FormatSpec(
    name="ell",
    container=ELL,
    from_dense=ell_from_dense,
    to_dense=ell_to_dense,
    prepare=_ell_prepare,
    spmv=_ell_spmv,
    reference=_ref_ell,
    footprint=_ell_footprint,
    card_launch=_ell_card_launch,
    card_work=_ell_card_work,
    priority=10,
    description="ELLPACK dense value/column planes",
))
register_format(FormatSpec(
    name="bell",
    container=BELL,
    from_dense=bell_from_dense,
    to_dense=bell_to_dense,
    prepare=_bell_prepare,
    spmv=_bell_spmv,
    reference=_ref_bell,
    footprint=_bell_footprint,
    card_launch=_bell_card_launch,
    card_work=_bell_card_work,
    priority=20,
    description="Blocked ELL over (br x 128) dense blocks",
))
register_format(FormatSpec(
    name="sell",
    container=SELL,
    from_dense=sell_from_dense,
    to_dense=sell_to_dense,
    prepare=_sell_prepare,
    spmv=_sell_spmv,
    reference=_ref_sell,
    footprint=_sell_footprint,
    card_launch=_sell_card_launch,
    card_work=_sell_card_work,
    priority=30,
    description="Sliced ELL (SELL-C-q) ragged storage",
))
