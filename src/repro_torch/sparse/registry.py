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
  ``useful_flops == 2 * nnz``.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels.common import (
    FAST_MEMORY_BYTES,
    LANE,
    InfeasibleConfig,
    KernelSchedule,
    ceil_to,
    pad_axis,
    resolve_device,
)

__all__ = [
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
        self.row_counts = (dense != 0).sum(axis=1).astype(np.int64)
        self.nnz = int(self.row_counts.sum())
        self.max_nnz = int(self.row_counts.max(initial=0))
        self._mask = dense != 0

    @lru_cache(maxsize=16)
    def block_occupancy(self, br: int, bc: int) -> tuple[int, int]:
        """(#occupied blocks, max occupied blocks per block-row)."""
        pr, pc = ceil_to(self.n_rows, br), ceil_to(self.n_cols, bc)
        m = np.zeros((pr, pc), dtype=bool)
        m[: self.n_rows, : self.n_cols] = self._mask
        occ = m.reshape(pr // br, br, pc // bc, bc).any(axis=(1, 3))
        per_row = occ.sum(axis=1)
        return int(occ.sum()), int(per_row.max(initial=0))

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
from repro_torch.kernels.csr import csr_spmv  # noqa: E402
from repro_torch.kernels.ell import ell_spmv  # noqa: E402
from repro_torch.kernels.sell import sell_spmv  # noqa: E402
from repro_torch.sparse.formats import (  # noqa: E402
    BELL,
    CSR,
    ELL,
    SELL,
    to_tensor,
    bell_from_dense,
    bell_to_dense,
    csr_from_dense,
    csr_to_dense,
    ell_from_dense,
    ell_to_dense,
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


# --- ELL -------------------------------------------------------------------


def _ell_prepare(dense: np.ndarray, schedule: KernelSchedule, *, device=None) -> ELL:
    device = resolve_device(device)
    dense = np.asarray(dense)
    n_rows, _ = dense.shape
    rpb, nt = schedule.rows_per_block, schedule.nnz_tile
    counts_max = int((dense != 0).sum(axis=1).max(initial=0))
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


# --- BELL ------------------------------------------------------------------


def _bell_prepare(dense: np.ndarray, schedule: KernelSchedule, *, device=None) -> BELL:
    dense = np.asarray(dense)
    n_rows, n_cols = dense.shape
    br = min(schedule.rows_per_block, 256)
    nbr = ceil_to(n_rows, br) // br
    # upper-bound occupancy estimate before materializing
    occ_bound = min((dense != 0).sum(), nbr * (ceil_to(n_cols, LANE) // LANE))
    check_storage_bytes(int(occ_bound) * br * LANE * 8 // max(nbr, 1) * nbr, "BELL")
    return bell_from_dense(dense, br=br, bc=LANE, device=device)


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


register_format(FormatSpec(
    name="csr",
    container=CSR,
    from_dense=csr_from_dense,
    to_dense=csr_to_dense,
    prepare=_csr_prepare,
    spmv=_csr_spmv,
    reference=_ref_csr,
    footprint=_csr_footprint,
    priority=0,
    description="Compressed Sparse Row (vector-CSR kernel, warp per row)",
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
    priority=30,
    description="Sliced ELL (SELL-C-q) ragged storage",
))
