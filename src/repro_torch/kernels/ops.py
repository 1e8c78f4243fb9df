"""Public SpMV kernel API: schedule-aware preparation + dispatch.

``prepare`` converts a dense matrix into the requested format with storage
geometry matched to a ``KernelSchedule`` (the compile-time parameters the
Auto-SpMV predictor emits) and puts it on ``device``; ``spmv`` runs the
matching kernel on the container's device (``spmspv`` / ``compile_spmspv``:
the sparse-input-vector twin over a ``CscEll``). Both are thin lookups into the
pluggable format registry (``repro_torch.sparse.registry``): the per-format
conversion, alignment padding, feasibility checks, and kernel binding live
on each ``FormatSpec``, so a format registered at runtime is served here
with no code change.

``device=None`` means ``"cuda"`` everywhere and raises where CUDA is absent;
the CPU (plain PyTorch versions) is used only when the caller names it.

The registry import is deliberately lazy (inside the functions): this module
is imported by ``repro_torch.kernels.__init__``, which the sparse substrate
itself imports for the tiling constants — a module-level registry import
would close that cycle during package initialization.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from functools import cached_property
from typing import Any, Hashable

import numpy as np
import torch

from repro_torch.kernels.common import (
    DEFAULT_SCHEDULE,
    InfeasibleConfig,  # noqa: F401  (canonical home moved to kernels.common)
    KernelSchedule,
    resolve_device,
)
from repro_torch.obs.metrics import get_metrics
from repro_torch.obs.trace import get_tracer, span as _span

_TRACER = get_tracer()

# memo counters mirrored into the process metrics registry so a metrics
# export sees kernel-compile economics without importing this module
_M_HITS = get_metrics().counter("spmv_kernel_memo_hits_total")
_M_COMPILES = get_metrics().counter("spmv_kernel_memo_compiles_total")
_M_EVICTIONS = get_metrics().counter("spmv_kernel_memo_evictions_total")


def prepare(
    dense: np.ndarray,
    fmt: str,
    schedule: KernelSchedule = DEFAULT_SCHEDULE,
    *,
    device: str | torch.device | None = None,
) -> Any:
    """Convert ``dense`` to ``fmt`` with schedule-aligned storage geometry."""
    from repro_torch.sparse.registry import get_format

    return get_format(fmt).prepare(
        np.asarray(dense), schedule, device=resolve_device(device)
    )


def spmv(
    mat: Any, x, schedule: KernelSchedule = DEFAULT_SCHEDULE
) -> torch.Tensor:
    """Run the SpMV kernel matching ``type(mat)`` on the container's device;
    returns y: (n_rows,). ``x`` may be a tensor or a host array."""
    from repro_torch.sparse.registry import spec_for

    return spec_for(mat).spmv(mat, x, schedule)


def spmm(mat: Any, X, schedule: KernelSchedule = DEFAULT_SCHEDULE) -> torch.Tensor:
    """Multi-vector SpMV ``Y = A @ X`` with ``X: (n_cols, k)`` (a tensor or a
    host array), on the container's device; returns ``Y: (n_rows, k)``.
    ELL only, as in the reference (the MoE-dispatch shape)."""
    from repro_torch.kernels.ell import ell_spmm
    from repro_torch.sparse.formats import ELL

    if not isinstance(mat, ELL):
        raise TypeError("spmm currently supports ELL")
    X = torch.as_tensor(X, dtype=torch.float32, device=mat.data.device).contiguous()
    return ell_spmm(mat.data, mat.cols, X, schedule)[: mat.shape[0]]


def spmspv(
    mat, active: np.ndarray, xvals: np.ndarray, schedule: KernelSchedule = DEFAULT_SCHEDULE
) -> torch.Tensor:
    """Sparse-input-vector SpMV over a ``CscEll`` container, on its device.

    ``active`` holds the frontier's column indices and ``xvals`` the
    corresponding x values (host arrays); work scales with the frontier's
    column nnz, not nnz(A). See ``repro_torch.kernels.spmspv`` for the
    kernel design."""
    from repro_torch.kernels.spmspv import CscEll, csc_spmspv

    if not isinstance(mat, CscEll):
        raise TypeError("spmspv expects a CscEll container (see compile_spmspv)")
    return csc_spmspv(mat, active, xvals, schedule)


def stored_bytes(mat) -> int:
    """Bytes a container stores for its kernel: ``nbytes_core`` where the
    format keeps companions its kernel never reads, else ``nbytes``, else
    its tensors'."""
    for attr in ("nbytes_core", "nbytes"):
        n = getattr(mat, attr, None)
        if n is not None:
            return int(n)
    return sum(t.numel() * t.element_size() for t in vars(mat).values()
               if isinstance(t, torch.Tensor))


@dataclass(frozen=True)
class PreparedSpmv:
    """A (format, schedule)-specialized SpMV — what compile-time mode emits.

    With the tracer on, a call is one ``spmv.call`` span (device-timed on a
    CUDA device) carrying ``fmt`` and ``bytes``: the stored container plus
    one float32 ``x`` and ``y``, counted once per kernel."""

    mat: Any  # a registered format container (CSR / ELL / BELL / SELL / plugin)
    schedule: KernelSchedule
    device: torch.device

    def __call__(self, x) -> torch.Tensor:
        if not _TRACER.enabled:
            return spmv(self.mat, x, self.schedule)
        fmt, nbytes = self._trace_attrs
        with _TRACER.device_span("spmv.call", self.device, fmt=fmt, bytes=nbytes):
            return spmv(self.mat, x, self.schedule)

    @cached_property
    def _trace_attrs(self) -> tuple[str, int]:
        from repro_torch.sparse.registry import spec_for

        n_rows, n_cols = self.mat.shape
        return spec_for(self.mat).name, stored_bytes(self.mat) + 4 * (n_rows + n_cols)


def matrix_fingerprint(dense: np.ndarray) -> str:
    """Content hash of a dense-held matrix — the kernel-memo identity.

    Two matrices with equal bytes/shape/dtype share every prepared kernel;
    the session layer uses this to deduplicate batched tuning requests.
    """
    a = np.ascontiguousarray(np.asarray(dense))
    h = hashlib.sha256()
    h.update(str((a.shape, str(a.dtype))).encode())
    h.update(a.tobytes())
    return h.hexdigest()[:32]


# Process-wide LRU memo of prepared kernels, keyed by (caller key, fmt,
# schedule, device). Opt-in via ``compile_spmv(..., memo_key=...)`` so
# one-off callers don't pin large format storage. Bounded: each entry holds
# the full converted matrix storage on its device, so an unbounded memo on a
# serving path streaming distinct matrices would grow memory until OOM.
# Fused composite kernels share the memo with a "fused:<fmt>+<fmt>..."
# format tag and the composite-plan signature in the schedule slot (one
# entry per plan).
_KERNEL_MEMO: "OrderedDict[tuple, object]" = OrderedDict()
_MEMO_STATS = {"hits": 0, "compiles": 0, "evictions": 0}
_MEMO_LIMIT = 256


def kernel_memo_stats() -> dict[str, int]:
    """Copy of the process-wide memo counters (hits / compiles / evictions)."""
    return dict(_MEMO_STATS)


def kernel_memo_size() -> int:
    return len(_KERNEL_MEMO)


def kernel_memo_limit() -> int:
    return _MEMO_LIMIT


def _evict_over_limit() -> None:
    while len(_KERNEL_MEMO) > _MEMO_LIMIT:
        _KERNEL_MEMO.popitem(last=False)
        _MEMO_STATS["evictions"] += 1
        _M_EVICTIONS.inc()


def _memo_get(key):
    """A memo hit (counted, moved to the LRU end) or None."""
    hit = _KERNEL_MEMO.get(key)
    if hit is not None:
        _MEMO_STATS["hits"] += 1
        _M_HITS.inc()
        _KERNEL_MEMO.move_to_end(key)
    return hit


def _memo_put(key, kernel) -> None:
    # counters cover memoized traffic only, so hits/(hits+compiles) is a
    # true memo hit rate (plain one-off compiles don't skew it)
    _MEMO_STATS["compiles"] += 1
    _M_COMPILES.inc()
    _KERNEL_MEMO[key] = kernel
    _evict_over_limit()


def set_kernel_memo_limit(limit: int) -> None:
    """Resize the LRU bound (evicts immediately if shrinking)."""
    global _MEMO_LIMIT
    if limit < 1:
        raise ValueError("kernel memo limit must be >= 1")
    _MEMO_LIMIT = limit
    _evict_over_limit()


def kernel_memoized(
    memo_key: Hashable,
    fmt: str,
    schedule: KernelSchedule = DEFAULT_SCHEDULE,
    *,
    device: str | torch.device | None = None,
) -> bool:
    """Whether ``compile_spmv`` with these arguments would be a memo hit.

    Lets the session's amortized-overhead accounting charge the conversion
    term only when conversion will actually run."""
    return (memo_key, fmt, schedule, resolve_device(device)) in _KERNEL_MEMO


def clear_kernel_memo() -> None:
    _KERNEL_MEMO.clear()


def _fused_tag_contains(tag, fmt: str) -> bool:
    """Whether a fused memo tag ("fused:ell+csr+...") involves ``fmt``."""
    return (
        isinstance(tag, str)
        and tag.startswith(_FUSED_TAG_PREFIX)
        and fmt in tag[len(_FUSED_TAG_PREFIX) :].split("+")
    )


def evict_kernel_memo_format(fmt: str) -> int:
    """Drop every memoized kernel of one format.

    Called by the registry when a format is unregistered or re-registered:
    a memoized ``PreparedSpmv`` must not outlive the ``FormatSpec`` that
    built it (its container would no longer resolve in ``spec_for``, or
    would silently run the old implementation). Fused composite kernels are
    evicted when ANY of their block formats matches — their flattened
    streams were lowered through the retiring ``FormatSpec``."""
    stale = [
        k for k in _KERNEL_MEMO if k[1] == fmt or _fused_tag_contains(k[1], fmt)
    ]
    for k in stale:
        del _KERNEL_MEMO[k]
        _MEMO_STATS["evictions"] += 1
        _M_EVICTIONS.inc()
    return len(stale)


def compile_spmv(
    dense: np.ndarray,
    fmt: str,
    schedule: KernelSchedule = DEFAULT_SCHEDULE,
    *,
    device: str | torch.device | None = None,
    memo_key: Hashable | None = None,
) -> PreparedSpmv:
    """prepare + bind: the full compile-time-mode product.

    With ``memo_key`` (typically ``matrix_fingerprint(dense)``) the prepared
    kernel is memoized process-wide: repeated compilation requests for the
    same (matrix, format, schedule, device) return the existing
    ``PreparedSpmv`` without re-running conversion — the ``c`` term of the
    §5.3 overhead model is paid once per unique matrix (until LRU
    eviction). The device is part of the key, so CPU and CUDA kernels never
    alias."""
    device = resolve_device(device)
    key = (memo_key, fmt, schedule, device) if memo_key is not None else None
    hit = _memo_get(key) if key is not None else None
    if hit is not None:
        return hit
    with _span("kernel.compile", fmt=fmt):
        prepared = PreparedSpmv(prepare(dense, fmt, schedule, device=device), schedule, device)
    if key is not None:
        _memo_put(key, prepared)
    return prepared


def compile_spmv_block(
    dense: np.ndarray,
    row_start: int,
    row_end: int,
    fmt: str,
    schedule: KernelSchedule = DEFAULT_SCHEDULE,
    *,
    device: str | torch.device | None = None,
    memo_key: Hashable | None = None,
) -> PreparedSpmv:
    """``compile_spmv`` for one row block of a larger matrix.

    The memo identity composes the caller's whole-matrix key with the row
    range, so per-block kernels are memoized (and LRU-evicted, and
    format-evicted) exactly like whole-matrix kernels — two composite plans
    over the same matrix share every block they agree on, without colliding
    with the monolithic kernel for the same matrix.
    """
    block = np.asarray(dense)[row_start:row_end]
    key = (memo_key, row_start, row_end) if memo_key is not None else None
    return compile_spmv(block, fmt, schedule, device=device, memo_key=key)


_FUSED_TAG_PREFIX = "fused:"


def fused_plan_signature(plan) -> tuple:
    """Hashable identity of a ``CompositePlan``'s executable content.

    Two plans lower to the same fused stream iff their (row range, format,
    schedule) tuples agree per block — the memo key component that makes
    "one kernel memo entry keyed on the composite plan" precise."""
    return tuple(
        (bp.block.row_start, bp.block.row_end, bp.fmt, bp.schedule)
        for bp in plan.blocks
    )


def compile_spmv_fused(
    dense: np.ndarray,
    plan,
    *,
    device: str | torch.device | None = None,
    memo_key: Hashable | None = None,
):
    """Lower a ``CompositePlan`` to its single-launch fused kernel.

    The whole composite memoizes as ONE entry: the format slot carries a
    ``fused:<fmt>+<fmt>...`` tag (so ``evict_kernel_memo_format`` retires it
    with any constituent format), the schedule slot the plan signature, the
    last slot the device. Returns a ``repro_torch.kernels.fused.FusedSpmv``."""
    from repro_torch.kernels.fused import lower_fused

    device = resolve_device(device)
    formats = "+".join(bp.fmt for bp in plan.blocks)
    key = None
    if memo_key is not None:
        key = (memo_key, _FUSED_TAG_PREFIX + formats, fused_plan_signature(plan), device)
        hit = _memo_get(key)
        if hit is not None:
            return hit
    with _span("kernel.compile", fused=True, formats=formats):
        kernel = lower_fused(dense, plan, device=device)
    if key is not None:
        _memo_put(key, kernel)
    return kernel


_SPMSPV_TAG = "spmspv"


@dataclass(frozen=True)
class PreparedSpmspv:
    """A schedule-specialized SpMSpV — the sparse-frontier twin of
    ``PreparedSpmv``.

    Holds the column-slice storage (on ``device``) plus the host-side
    per-column nnz vector, so the adaptive policy can price a frontier
    (``modeled_work``) without touching device memory.
    """

    mat: Any  # repro_torch.kernels.spmspv.CscEll
    schedule: KernelSchedule
    device: torch.device
    col_nnz: Any = None  # np.ndarray (n_cols,) int64, on the host

    def call_frontier(self, active: np.ndarray, xvals: np.ndarray) -> torch.Tensor:
        return spmspv(self.mat, active, xvals, self.schedule)

    def __call__(self, x) -> torch.Tensor:
        """Dense-in/dense-out convenience: extracts the frontier host-side."""
        from repro_torch.sparse.formats import _np

        xh = _np(x)
        active = np.flatnonzero(xh).astype(np.int32)
        return self.call_frontier(active, xh[active])

    def modeled_work(self, active: np.ndarray) -> int:
        """Stored nonzeros this frontier touches — the SpMSpV cost model."""
        if self.col_nnz is None:
            return 0
        return int(np.asarray(self.col_nnz)[np.asarray(active, dtype=np.int64)].sum())


def compile_spmspv(
    dense: np.ndarray,
    schedule: KernelSchedule = DEFAULT_SCHEDULE,
    *,
    device: str | torch.device | None = None,
    memo_key: Hashable | None = None,
) -> PreparedSpmspv:
    """prepare + bind the sparse-input-vector path.

    Memoizes alongside the SpMV kernels with the ``"spmspv"`` tag in the
    format slot and the device in the last — one extra entry per (matrix,
    schedule, device), subject to the same LRU bound and counters, so an
    iterative solve that uses both paths pays each conversion once."""
    from repro_torch.kernels.spmspv import col_nnz as _col_nnz
    from repro_torch.kernels.spmspv import csc_from_dense

    device = resolve_device(device)
    key = (memo_key, _SPMSPV_TAG, schedule, device) if memo_key is not None else None
    hit = _memo_get(key) if key is not None else None
    if hit is not None:
        return hit
    with _span("kernel.compile", fmt=_SPMSPV_TAG):
        prepared = PreparedSpmspv(
            csc_from_dense(dense, schedule, device=device),
            schedule,
            device,
            _col_nnz(dense),
        )
    if key is not None:
        _memo_put(key, prepared)
    return prepared
