"""SpMSpV — sparse matrix x SPARSE vector: storage, CUDA kernel wrapper and
its plain PyTorch version.

Iterative graph workloads (BFS-like frontiers, power iteration from a seed
vertex, personalized PageRank pushes) multiply the same matrix by a vector
whose nonzero count starts tiny and densifies across iterations. A dense
SpMV touches every stored nonzero of A regardless; SpMSpV touches only the
columns the frontier activates (Li et al., "Adaptive SpMV/SpMSpV on GPUs
for Input Vectors of Varied Sparsity", arXiv:2006.16767).

* **Storage** (``CscEll``): column-major ELL — per-column value/row-id
  slices padded to a width ``W`` that is a whole number of ``nnz_tile``
  quanta (the reference package's layout, array for array). One extra
  all-padding column at index ``n_cols`` is the *spill column*: frontier
  entries that point at it contribute exact zeros. Padding slots carry
  value 0 and row ``n_rows`` (the spill row) and form a contiguous tail of
  every column. Built in numpy on the host and copied to ``device`` once.
* **Kernel** (``csrc/spmspv_csc.cu``, launched by ``csc_spmspv_kernel``):
  ``y`` is zeroed on the stream, one warp per frontier entry walks its
  column in coalesced trips of ``32 * unroll`` slots and ``atomicAdd``\\ s
  ``value * x`` into ``y[row]``; the warp stops at the first padding slot
  (the tail), so work is proportional to ``sum(col_nnz[frontier])``, not to
  ``k * W``. The frontier length ``k`` is a runtime argument: nothing is
  padded to a power of two (``_frontier_pad`` stays for parity with the
  reference only). Float atomics make ``y`` vary in its last bits from run
  to run.

``csc_spmspv`` is the frontier-level wrapper (validation, empty-frontier
short cut, host→device copy of the frontier, spill slot truncated). On a
CUDA container it launches the kernel or raises; on a CPU container — and
only then — it takes ``csc_spmspv_plain``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.common import (
    DEFAULT_SCHEDULE,
    SUBLANE,
    InfeasibleConfig,
    KernelSchedule,
    bf16_round,
    ceil_to,
    check_operand,
    resolve_device,
)


@dataclass(frozen=True, eq=False)
class CscEll:
    """Column-major ELL: padded per-column slices, kernel-ready for SpMSpV.

    ``data[c]`` / ``rows[c]`` hold column ``c``'s nonzero values and row
    ids, zero-/spill-padded to the shared width. Row index ``n_rows`` is the
    spill row (padding slots); column index ``n_cols`` is the spill column
    (frontier padding) — all-zero by construction.
    """

    data: torch.Tensor  # (n_cols + 1, W) values, 0 on padding slots
    rows: torch.Tensor  # (n_cols + 1, W) int32 row ids, n_rows on padding
    shape: tuple[int, int]

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    @property
    def nbytes(self) -> int:
        return int(
            self.data.numel() * self.data.element_size()
            + self.rows.numel() * self.rows.element_size()
        )


def csc_from_dense(
    dense: np.ndarray,
    schedule: KernelSchedule = DEFAULT_SCHEDULE,
    dtype=np.float32,
    *,
    device: str | torch.device | None = None,
) -> CscEll:
    """Build the padded column-slice storage from a dense matrix.

    The slice width is the max column nnz rounded up to the schedule's
    ``nnz_tile`` so every column is a whole number of tiles. A matrix whose
    hub column approaches ``n_rows`` pads toward dense storage; that blow-up
    is rejected against the registry's storage bound exactly like an
    infeasible format conversion.
    """
    device = resolve_device(device)
    dense = np.asarray(dense)
    n_rows, n_cols = dense.shape
    col_t = dense.T  # (n_cols, n_rows): nonzeros below are column-major
    c_idx, r_idx = np.nonzero(col_t)
    counts = np.bincount(c_idx, minlength=n_cols)
    W = ceil_to(max(int(counts.max(initial=0)), 1), schedule.nnz_tile)
    from repro_torch.sparse.registry import MAX_STORAGE_BYTES  # lazy: import cycle

    nbytes = (n_cols + 1) * W * (np.dtype(dtype).itemsize + 4)
    if nbytes > MAX_STORAGE_BYTES:
        raise InfeasibleConfig(
            f"CscEll storage {nbytes} B exceeds bound {MAX_STORAGE_BYTES} B "
            f"(width {W} over {n_cols} columns)"
        )
    data = np.zeros((n_cols + 1, W), dtype=dtype)
    rows = np.full((n_cols + 1, W), n_rows, dtype=np.int32)
    # position of each nonzero within its column
    pos = np.arange(c_idx.size) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
    )
    data[c_idx, pos] = col_t[c_idx, r_idx]
    rows[c_idx, pos] = r_idx
    return CscEll(
        data=torch.from_numpy(data).to(device),
        rows=torch.from_numpy(rows).to(device),
        shape=(n_rows, n_cols),
    )


def col_nnz(dense: np.ndarray) -> np.ndarray:
    """Per-column nonzero counts — the SpMSpV modeled-work vector."""
    return (np.asarray(dense) != 0).sum(axis=0).astype(np.int64)


def _frontier_pad(k: int) -> int:
    """The reference kernel's padded frontier length (next power of two, at
    least one sublane). The CUDA kernel takes ``k`` as is; kept for parity."""
    return max(SUBLANE, 1 << (max(k, 1) - 1).bit_length())


def csc_spmspv_plain(
    data: torch.Tensor,
    rows: torch.Tensor,
    active: torch.Tensor,
    xvals: torch.Tensor,
    n_rows: int,
    schedule: KernelSchedule,
) -> torch.Tensor:
    """Gather the active columns, multiply by their x values, ``index_add_``
    into an ``(n_rows + 1,)`` float32 ``y`` (spill slot last). bf16: operands
    and products rounded to bf16, the sum taken in float32 and rounded once
    (as ``csr_spmv_plain`` does)."""
    a = active.long()
    d, r = data[a], rows[a].long()  # (k, W)
    bf16 = schedule.accum_dtype == "bfloat16"
    xv = xvals[:, None]
    prods = bf16_round(bf16_round(d) * bf16_round(xv)) if bf16 else d * xv
    y = torch.zeros(n_rows + 1, dtype=torch.float32, device=data.device)
    y.index_add_(0, r.reshape(-1), prods.reshape(-1).to(torch.float32))
    return bf16_round(y) if bf16 else y


def csc_spmspv_kernel(
    data: torch.Tensor,
    rows: torch.Tensor,
    active: torch.Tensor,
    xvals: torch.Tensor,
    n_rows: int,
    schedule: KernelSchedule,
) -> torch.Tensor:
    """The kernel call on prepared operands (the reference's
    ``csc_spmspv_pallas``): ``data/rows (n_cols + 1, W)`` with
    ``W % nnz_tile == 0``; ``active (k,)`` int32 column indices (entries
    equal to ``n_cols`` hit the spill column) and ``xvals (k,)`` float32, on
    the container's device. Returns ``y: (n_rows + 1,)`` (spill slot last).
    Index ranges are the caller's contract (``csc_spmspv`` checks them).
    B6's launch counter is ``csc_spmspv.launches``, bumped here, where the
    kernel launches."""
    dev = data.device
    check_operand(data, "data", torch.float32, 2, dev)
    check_operand(rows, "rows", torch.int32, 2, dev)
    check_operand(active, "active", torch.int32, 1, dev)
    check_operand(xvals, "xvals", torch.float32, 1, dev)
    if rows.shape != data.shape or active.shape != xvals.shape:
        raise ValueError("CscEll arrays or frontier arrays disagree in shape")
    W, nt = int(data.shape[1]), schedule.nnz_tile
    if W % nt:
        raise InfeasibleConfig(
            f"CscEll width {W} not aligned to nnz_tile {nt}; re-prepare with "
            "this schedule"
        )
    if dev.type == "cpu":
        return csc_spmspv_plain(data, rows, active, xvals, n_rows, schedule)
    if dev.type != "cuda":
        raise RuntimeError(f"csc_spmspv has no kernel for device {dev}")
    from repro_torch.kernels.build import bind, check_launch

    y = torch.empty(n_rows + 1, dtype=torch.float32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = bind("spmspv_csc", "spmspv_csc_launch", [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp])
    with torch.cuda.device(dev):
        err = fn(
            data.data_ptr(), rows.data_ptr(), active.data_ptr(), xvals.data_ptr(),
            y.data_ptr(), int(active.shape[0]), W, n_rows, schedule.unroll,
            int(schedule.accum_dtype == "bfloat16"),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(err, "csc_spmspv")
    csc_spmspv.launches += 1
    return y


def csc_spmspv(
    mat: CscEll,
    active,
    xvals,
    schedule: KernelSchedule = DEFAULT_SCHEDULE,
) -> torch.Tensor:
    """Frontier-level wrapper: validates, copies the frontier to the
    container's device, dispatches, truncates the spill slot.

    ``active``/``xvals`` are host arrays of the frontier's column indices
    and values at their true length ``k`` (any k from 0 to n_cols); an empty
    frontier short-circuits to zeros without a kernel launch. Returns
    ``y: (n_rows,)`` float32 on the container's device.
    """
    n_rows, n_cols = mat.shape
    active = np.ascontiguousarray(active, dtype=np.int32).reshape(-1)
    xvals = np.ascontiguousarray(xvals, dtype=np.float32).reshape(-1)
    if active.shape != xvals.shape:
        raise ValueError(
            f"frontier mismatch: {active.shape[0]} indices, {xvals.shape[0]} values"
        )
    dev = mat.data.device
    if active.size == 0:
        return torch.zeros(n_rows, dtype=torch.float32, device=dev)
    if active.min() < 0 or active.max() >= n_cols:
        raise ValueError("frontier indices out of range")
    y = csc_spmspv_kernel(
        mat.data,
        mat.rows,
        torch.from_numpy(active).to(dev),
        torch.from_numpy(xvals).to(dev),
        n_rows,
        schedule,
    )
    return y[:n_rows]


csc_spmspv.launches = 0  # B6 kernel launches made by this process
