"""BCSR: blocked compressed-sparse-row — the registry's fifth format.

A CMRS-spirited (Koza et al., arXiv:1203.2946) row-compressed relative of
BELL: storage is a *flat* list of occupied (br x 128) blocks with per-block
block-row / block-column ids, instead of BELL's ELL-style per-block-row
padding to ``max_blocks``. On matrices whose block occupancy is skewed
across block-rows (power-law graphs), BCSR stores only the occupied blocks
— the same padding-elimination argument CSR makes over ELL, one level up.

On the card the kernel (``repro_torch.kernels.bcsr``, ``csrc/spmv_bcsr.cu``)
runs one CTA per block row over ``block_ptr``: BELL's body with a ragged
bound, no atomics. ``block_rows`` (padding blocks carry ``n_block_rows``,
the spill row) serves the plain version and the conversion back to dense.

This module is deliberately *plugin-shaped*: it touches none of the
dispatch layers (ops / tuning_space / objectives / session / serving).
Importing it (or calling ``register()``) is the entire integration — the
format then appears in ``full_space()``, the tuning dataset, classifier
labels and serves through ``SpmvServer``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.bcsr import bcsr_spmv
from repro_torch.kernels.common import (
    FAST_MEMORY_BYTES,
    LANE,
    SUBLANE,
    InfeasibleConfig,
    KernelSchedule,
    ceil_to,
    resolve_device,
)
from repro_torch.sparse.formats import _np, to_tensor
from repro_torch.sparse.registry import (
    FormatSpec,
    KernelFootprint,
    MatrixStats,
    check_storage_bytes,
    register_format,
)

_VAL_B, _IDX_B = 4.0, 4.0


@dataclass(frozen=True, eq=False)
class BCSR:
    """Blocked CSR: flat occupied (br x bc) blocks + block-row compression.

    ``data[k]`` is the k-th stored block (block-row-major order); its block
    coordinates are ``(block_rows[k], block_cols[k])``. Trailing padding
    blocks are all-zero with ``block_col == 0`` and ``block_row ==
    n_block_rows`` (the spill row). ``block_ptr`` is the CSR-style pointer
    over block-rows covering the *real* (unpadded) blocks.
    """

    data: torch.Tensor  # (n_blocks_pad, br, bc)
    block_cols: torch.Tensor  # (n_blocks_pad,) int32
    block_rows: torch.Tensor  # (n_blocks_pad,) int32
    block_ptr: torch.Tensor  # (n_block_rows + 1,) int32
    shape: tuple[int, int]
    br: int
    bc: int

    @property
    def n_block_rows(self) -> int:
        return int(self.block_ptr.shape[0] - 1)

    @property
    def n_blocks(self) -> int:
        """Real (unpadded) stored blocks."""
        return int(self.block_ptr[-1])

    @property
    def nbytes_core(self) -> int:
        arrs = (self.data, self.block_cols, self.block_ptr)
        return int(sum(a.numel() * a.element_size() for a in arrs))

    @property
    def nbytes(self) -> int:
        return self.nbytes_core + int(self.block_rows.numel() * self.block_rows.element_size())


# ---------------------------------------------------------------------------
# Host-side conversion (numpy; timeable as the paper's c_latency)
# ---------------------------------------------------------------------------


def bcsr_from_dense(
    dense: np.ndarray,
    br: int = SUBLANE,
    bc: int = LANE,
    dtype=np.float32,
    pad_blocks_to: int = 1,
    *,
    device=None,
) -> BCSR:
    device = resolve_device(device)
    dense = np.asarray(dense)
    n_rows, n_cols = dense.shape
    pr, pc = ceil_to(n_rows, br), ceil_to(n_cols, bc)
    padded = np.zeros((pr, pc), dtype=dtype)
    padded[:n_rows, :n_cols] = dense
    nbr, nbc = pr // br, pc // bc
    blocks = padded.reshape(nbr, br, nbc, bc).transpose(0, 2, 1, 3)  # (nbr, nbc, br, bc)
    occupied = (blocks != 0).any(axis=(2, 3))  # (nbr, nbc)
    rows_idx, cols_idx = np.nonzero(occupied)  # block-row-major order
    nb = rows_idx.size
    counts = np.bincount(rows_idx, minlength=nbr)
    block_ptr = np.zeros(nbr + 1, dtype=np.int32)
    np.cumsum(counts, out=block_ptr[1:])
    nb_pad = ceil_to(max(nb, 1), max(pad_blocks_to, 1))
    data = np.zeros((nb_pad, br, bc), dtype=dtype)
    block_cols = np.zeros(nb_pad, dtype=np.int32)
    block_rows = np.full(nb_pad, nbr, dtype=np.int32)  # padding -> spill row
    data[:nb] = blocks[rows_idx, cols_idx]
    block_cols[:nb] = cols_idx
    block_rows[:nb] = rows_idx
    return BCSR(
        data=to_tensor(data, device),
        block_cols=to_tensor(block_cols, device),
        block_rows=to_tensor(block_rows, device),
        block_ptr=to_tensor(block_ptr, device),
        shape=(n_rows, n_cols),
        br=br,
        bc=bc,
    )


def bcsr_to_dense(mat: BCSR) -> np.ndarray:
    n_rows, n_cols = mat.shape
    data = _np(mat.data)
    out = np.zeros((n_rows, n_cols), dtype=data.dtype)
    brow = _np(mat.block_rows)
    bcol = _np(mat.block_cols)
    nbr = mat.n_block_rows
    for k in range(data.shape[0]):
        if brow[k] >= nbr:  # padding block
            continue
        r0, c0 = int(brow[k]) * mat.br, int(bcol[k]) * mat.bc
        rr = min(mat.br, n_rows - r0)
        cc = min(mat.bc, n_cols - c0)
        if rr > 0 and cc > 0:
            out[r0 : r0 + rr, c0 : c0 + cc] += data[k][:rr, :cc]
    return out


# ---------------------------------------------------------------------------
# Plain-torch oracle
# ---------------------------------------------------------------------------


def spmv_bcsr(mat: BCSR, x) -> torch.Tensor:
    """Per-block matvec + segment sum over ``block_rows`` (spill row
    dropped), float32 throughout."""
    x = torch.as_tensor(x, dtype=mat.data.dtype, device=mat.data.device)
    n_rows, bc = mat.shape[0], mat.bc
    xp = torch.zeros(ceil_to(x.shape[0], bc), dtype=x.dtype, device=x.device)
    xp[: x.shape[0]] = x
    v = torch.einsum("krc,kc->kr", mat.data, xp.reshape(-1, bc)[mat.block_cols.long()])
    y = torch.zeros((mat.n_block_rows + 1, mat.br), dtype=x.dtype, device=x.device)
    y.index_add_(0, mat.block_rows.long(), v)
    return y[: mat.n_block_rows].reshape(-1)[:n_rows]


# ---------------------------------------------------------------------------
# FormatSpec entrypoints
# ---------------------------------------------------------------------------


def _blocks_per_tile(schedule: KernelSchedule) -> int:
    # nnz_tile is lane-quantized; one (br x 128) block consumes 128 lanes,
    # so the schedule's tile maps to a block-count storage quantum
    return max(schedule.nnz_tile // LANE, 1)


def _bcsr_prepare(dense: np.ndarray, schedule: KernelSchedule, *, device=None) -> BCSR:
    dense = np.asarray(dense)
    n_rows, n_cols = dense.shape
    br = min(schedule.rows_per_block, 256)
    nbr = ceil_to(n_rows, br) // br
    occ_bound = min((dense != 0).sum(), nbr * (ceil_to(n_cols, LANE) // LANE))
    check_storage_bytes(int(occ_bound) * br * LANE * 8, "BCSR")
    return bcsr_from_dense(
        dense, br=br, bc=LANE, pad_blocks_to=_blocks_per_tile(schedule), device=device
    )


def _bcsr_spmv(mat: BCSR, x, schedule: KernelSchedule):
    n_rows, n_cols = mat.shape
    bpt = _blocks_per_tile(schedule)
    if mat.data.shape[0] % bpt:
        raise InfeasibleConfig(
            f"BCSR block count {mat.data.shape[0]} not aligned to the "
            f"nnz_tile={schedule.nnz_tile} storage quantum ({bpt} blocks); "
            "convert with prepare(..., schedule)"
        )
    x = torch.as_tensor(x, dtype=torch.float32, device=mat.data.device).contiguous()
    xp = torch.zeros(ceil_to(n_cols, mat.bc), dtype=x.dtype, device=x.device)
    xp[:n_cols] = x
    y = bcsr_spmv(
        mat.data, mat.block_cols, mat.block_rows, mat.block_ptr,
        xp.reshape(-1, mat.bc), schedule,
    )
    return y.reshape(-1)[:n_rows]


def _bcsr_footprint(stats: MatrixStats, schedule: KernelSchedule) -> KernelFootprint:
    n, m, nnz = stats.n_rows, stats.n_cols, stats.nnz
    x_bytes, y_bytes = m * _VAL_B, n * _VAL_B
    br, bc = min(schedule.rows_per_block, 256), LANE
    n_blocks, _ = stats.block_occupancy(br, bc)
    nb_pad = ceil_to(max(n_blocks, 1), _blocks_per_tile(schedule))
    nbr = ceil_to(n, br) // br
    stored = float(nb_pad) * br * bc  # row-compressed: occupied blocks only
    x_traffic = (
        float(nb_pad) * bc * _VAL_B  # one x panel fetched per stored block
        if schedule.x_residency == "stream"
        else x_bytes
    )
    hbm = stored * _VAL_B + nb_pad * 2 * _IDX_B + x_traffic + y_bytes
    steps = float(nb_pad)
    tile_b = br * bc * _VAL_B + bc * _VAL_B
    # the working set the cache must hold: two blocks with their panels, the
    # output rows and, with x_residency "vmem", all of x — against the L2
    # (FAST_MEMORY_BYTES), as BELL's footprint is held
    vmem = (
        2 * tile_b
        + (nbr + 1) * br * _VAL_B
        + (x_bytes if schedule.x_residency == "vmem" else 0)
    )
    return KernelFootprint(
        2.0 * nnz,
        2 * stored,
        hbm,
        0.0,
        float(nb_pad) * br,  # per-block accumulate into the block row's y
        steps,
        1.0,
        vmem,
        vmem <= FAST_MEMORY_BYTES,
    )


BCSR_SPEC = FormatSpec(
    name="bcsr",
    container=BCSR,
    from_dense=bcsr_from_dense,
    to_dense=bcsr_to_dense,
    prepare=_bcsr_prepare,
    spmv=_bcsr_spmv,
    reference=spmv_bcsr,
    footprint=_bcsr_footprint,
    priority=40,
    description="Blocked CSR: flat occupied 8x128 blocks, row-compressed",
)


def register() -> FormatSpec:
    """Idempotent activation: make BCSR a live format everywhere."""
    return register_format(BCSR_SPEC, overwrite=True)


register()
