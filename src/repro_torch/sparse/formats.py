"""Sparse matrix storage formats: CSR, ELL, BELL, SELL (paper §2.3).

Each format is a frozen dataclass whose array fields are ``torch.Tensor``s on
one explicit device (float32 values, int32 indices) and whose structural
fields (shape, block size, slice height) are plain Python metadata.
Conversion happens on the host in numpy — the paper's run-time mode
explicitly performs conversion on the CPU and *measures* it (``c_latency``,
Table 7), so converters are written to be timeable as-is; their last step
puts the arrays on ``device``.

The storage conventions are the reference package's, array for array, so
both packages multiply the same storage (``container_from_numpy`` /
``container_to_numpy`` carry a container across as numpy arrays):

* ``CSR`` carries a ``row_ids`` companion (COO expansion of ``indptr``) for
  the plain ``index_add_`` version and the oracle; the CUDA kernel walks
  ``indptr`` and never reads it. ``nbytes_core`` excludes companions so
  that format size comparisons match the textbook definition.
* ``BELL`` blocks default to 8×128: a stored block row is 128 contiguous
  floats, one ``float4`` per lane of a warp.
* ``SELL`` keeps true ragged storage (flat data + slice pointers); slice
  widths are padded to the 128-element quantum ``q``.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import NamedTuple, Union

import numpy as np
import torch

# LANE/SUBLANE live in kernels/common.py (the single source of truth for the
# tiling quanta); re-exported here for backward compatibility.
from repro_torch.kernels.common import LANE, SUBLANE, resolve_device

# Deprecated: the four *seed* formats. New code should use
# ``repro_torch.sparse.registry.format_names()``, which also covers plugins.
FORMAT_NAMES = ("csr", "ell", "bell", "sell")


def _ceil_to(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


def _nbytes(*arrays) -> int:
    return int(sum(a.numel() * a.element_size() for a in arrays))


def _np(t) -> np.ndarray:
    """Host numpy view/copy of a tensor field (or pass an ndarray through)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclass(frozen=True, eq=False)
class CSR:
    """Compressed Sparse Row. ``row_ids`` serves the plain version and oracle."""

    data: torch.Tensor  # (nnz,) nonzero values
    indices: torch.Tensor  # (nnz,) column index per nonzero
    indptr: torch.Tensor  # (n_rows + 1,) row boundaries
    row_ids: torch.Tensor  # (nnz,) row index per nonzero (COO companion)
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def nbytes_core(self) -> int:
        return _nbytes(self.data, self.indices, self.indptr)

    @property
    def nbytes(self) -> int:
        return self.nbytes_core + _nbytes(self.row_ids)


@dataclass(frozen=True, eq=False)
class ELL:
    """ELLPACK: row-major dense (n_rows, max_nnz) value/column planes.

    Padding slots hold value 0 and column 0 — a "safe gather" convention so
    kernels need no masking on the X gather (0 * x[0] == 0).
    """

    data: torch.Tensor  # (n_rows, width)
    cols: torch.Tensor  # (n_rows, width) int32
    shape: tuple[int, int]

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    @property
    def nbytes_core(self) -> int:
        return _nbytes(self.data, self.cols)

    nbytes = nbytes_core


@dataclass(frozen=True, eq=False)
class BELL:
    """Blocked ELL: ELL over (br x bc) dense blocks.

    ``data[i, j]`` is the j-th stored block of block-row i; its block-column
    is ``block_cols[i, j]``. Padding blocks are all-zero with block-column 0.
    ``bell_from_dense`` writes each block row's real block-columns in
    strictly ascending order before its padding; the CUDA kernel relies on
    that order to stop at the padding (``kernels.bell.bell_live_blocks``).
    """

    data: torch.Tensor  # (n_block_rows, max_blocks, br, bc)
    block_cols: torch.Tensor  # (n_block_rows, max_blocks) int32
    shape: tuple[int, int]
    br: int
    bc: int

    @property
    def n_block_rows(self) -> int:
        return int(self.data.shape[0])

    @property
    def max_blocks(self) -> int:
        return int(self.data.shape[1])

    @property
    def nbytes_core(self) -> int:
        return _nbytes(self.data, self.block_cols)

    nbytes = nbytes_core


@dataclass(frozen=True, eq=False)
class SELL:
    """Sliced ELL (SELL-C-q): slices of C rows, per-slice padded width.

    True ragged storage: ``data``/``cols`` are flat concatenations of
    *column-major* (width_s, C) slice planes — element (row r, k-th stored
    nonzero) of slice s lives at ``slice_ptr[s] + k * C + r``. Column-major
    slices make every width-tile of a slice a contiguous ``nnz_tile * C``
    chunk, and makes thread r of a CTA stepping k read coalesced addresses.
    ``slice_ptr[s]`` is the flat element offset of slice s;
    ``slice_width[s] = (slice_ptr[s+1] - slice_ptr[s]) / C``. Widths are
    padded to the quantum ``q``. ``row_ids`` is the oracle-facing
    companion (row per element, == n_rows on padding slots).
    """

    data: torch.Tensor  # (total,)
    cols: torch.Tensor  # (total,) int32
    slice_ptr: torch.Tensor  # (n_slices + 1,) int32, element offsets
    slice_width: torch.Tensor  # (n_slices,) int32
    row_ids: torch.Tensor  # (total,) int32, == n_rows on padding slots
    shape: tuple[int, int]
    C: int

    @property
    def n_slices(self) -> int:
        return int(self.slice_width.shape[0])

    @property
    def nbytes_core(self) -> int:
        return _nbytes(self.data, self.cols, self.slice_ptr)

    @property
    def nbytes(self) -> int:
        return self.nbytes_core + _nbytes(self.slice_width, self.row_ids)


SparseFormat = Union[CSR, ELL, BELL, SELL]


# ---------------------------------------------------------------------------
# Host-side converters (numpy; timeable as the paper's c_latency)
# ---------------------------------------------------------------------------


# the scans ``shared_nonzeros`` keeps: id(array) -> [array, scan or None]
_SHARED_SCANS: dict[int, list] = {}


@contextmanager
def shared_nonzeros(dense: np.ndarray):
    """Inside the block, the converters of ``dense`` (this array object, as
    ``prepare`` passes it on) scan its nonzeros once and share the result:
    converting one matrix to many storage geometries, as the tuner's dataset
    does, pays the scan of the dense matrix once. The array is read-only
    inside the block, so the scan cannot go stale."""
    if not isinstance(dense, np.ndarray) or dense.ndim != 2:
        raise TypeError("shared_nonzeros takes a 2-D numpy array")
    if id(dense) in _SHARED_SCANS:  # already shared by an enclosing block
        yield dense
        return
    writeable = dense.flags.writeable
    dense.flags.writeable = False
    _SHARED_SCANS[id(dense)] = [dense, None]
    try:
        yield dense
    finally:
        del _SHARED_SCANS[id(dense)]
        dense.flags.writeable = writeable


def _scan(dense: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``np.nonzero(dense)`` (the same arrays, in the same row-major order),
    the nonzeros per row and their values, from the flat positions of the
    mask: ``np.nonzero`` tests a float matrix element by element and took
    most of a conversion at n ~ 14,000, and the values' gather is a cache
    miss each. Shared inside ``shared_nonzeros``; callers must not write to
    the arrays."""
    entry = _SHARED_SCANS.get(id(dense))
    if entry is not None and entry[0] is dense and entry[1] is not None:
        return entry[1]
    flat = np.flatnonzero(dense != 0)
    rows, cols = np.divmod(flat, dense.shape[1]) if dense.shape[1] else (flat, flat.copy())
    scan = (rows, cols, np.bincount(rows, minlength=dense.shape[0]), dense[rows, cols])
    if entry is not None and entry[0] is dense:
        entry[1] = scan
    return scan


def row_counts(dense: np.ndarray) -> np.ndarray:
    """Nonzeros per row of a dense matrix (int64)."""
    return _scan(dense)[2]


def csr_from_dense(dense: np.ndarray, dtype=np.float32, *, device=None) -> CSR:
    device = resolve_device(device)
    dense = np.asarray(dense)
    n_rows, n_cols = dense.shape
    rows, cols, _, values = _scan(dense)
    data = values.astype(dtype)
    counts = np.bincount(rows, minlength=n_rows)
    indptr = np.zeros(n_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    return CSR(
        data=to_tensor(data, device),
        indices=to_tensor(cols.astype(np.int32), device),
        indptr=to_tensor(indptr, device),
        row_ids=to_tensor(rows.astype(np.int32), device),
        shape=(n_rows, n_cols),
    )


def ell_from_dense(
    dense: np.ndarray, dtype=np.float32, min_width: int = 1, *, device=None
) -> ELL:
    device = resolve_device(device)
    # nonzeros are chosen after the cast: a value that rounds to 0 is not
    # stored, so no row holds a stored zero before a nonzero (the SpMM
    # kernel stops at a row's first zero)
    dense = np.asarray(dense).astype(dtype, copy=False)
    n_rows, n_cols = dense.shape
    rows, cc, counts, values = _scan(dense)
    width = max(int(counts.max(initial=0)), min_width)
    data = np.zeros((n_rows, width), dtype=dtype)
    cols = np.zeros((n_rows, width), dtype=np.int32)
    # position of each nonzero within its row
    pos = np.arange(rows.size) - np.repeat(np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    data[rows, pos] = values
    cols[rows, pos] = cc
    return ELL(
        data=to_tensor(data, device),
        cols=to_tensor(cols, device),
        shape=(n_rows, n_cols),
    )


class BellOccupancy(NamedTuple):
    """The nonzeros of a matrix after its cast to BELL's dtype (rows, cols,
    values) and its (block rows, block columns) grid of the ``br x bc``
    blocks that hold one (``occupied``)."""

    rows: np.ndarray
    cols: np.ndarray
    values: np.ndarray
    occupied: np.ndarray

    @property
    def max_blocks(self) -> int:
        """The blocks ``bell_from_dense`` stores per block row: the most
        occupied in any block row, at least 1."""
        return max(int(self.occupied.sum(axis=1).max(initial=0)), 1)


def bell_occupancy(dense: np.ndarray, br: int, bc: int = LANE, dtype=np.float32
                   ) -> BellOccupancy:
    """One scan of ``dense`` after its cast to ``dtype`` (shared inside
    ``shared_nonzeros``): what BELL's storage guard charges and
    ``bell_from_dense`` builds from. The nonzeros are chosen after the cast,
    as the reference's padded float32 copy chooses them."""
    dense = np.asarray(dense).astype(dtype, copy=False)
    rows, cols, _, values = _scan(dense)
    nbr, nbc = _ceil_to(dense.shape[0], br) // br, _ceil_to(dense.shape[1], bc) // bc
    occupied = np.zeros((nbr, nbc), dtype=bool)
    occupied[rows // br, cols // bc] = True
    return BellOccupancy(rows, cols, values, occupied)


def bell_from_dense(
    dense: np.ndarray, br: int = SUBLANE, bc: int = LANE, dtype=np.float32, *, device=None,
    occupancy: BellOccupancy | None = None,
) -> BELL:
    """BELL storage: each block row's occupied blocks in ascending block
    column, then zero blocks at block column 0. ``occupancy``: this
    matrix's ``bell_occupancy(dense, br, bc, dtype)``, where the caller has
    it (the storage guard's), so the matrix is scanned once."""
    device = resolve_device(device)
    n_rows, n_cols = np.shape(dense)
    occ = bell_occupancy(dense, br, bc, dtype) if occupancy is None else occupancy
    rows, cols, values, occupied = occ
    nbr, max_blocks = occupied.shape[0], occ.max_blocks
    slot = np.cumsum(occupied, axis=1) - 1  # each occupied block's place in its row
    data = np.zeros((nbr, max_blocks, br, bc), dtype=dtype)
    block_cols = np.zeros((nbr, max_blocks), dtype=np.int32)
    r, c = np.nonzero(occupied)
    block_cols[r, slot[r, c]] = c
    data[rows // br, slot[rows // br, cols // bc], rows % br, cols % bc] = values
    return BELL(
        data=to_tensor(data, device),
        block_cols=to_tensor(block_cols, device),
        shape=(n_rows, n_cols),
        br=br,
        bc=bc,
    )


def sell_from_dense(
    dense: np.ndarray, C: int = 4 * SUBLANE, q: int = LANE, dtype=np.float32, *, device=None
) -> SELL:
    device = resolve_device(device)
    # nonzeros are chosen after the cast, as in ell_from_dense (the SELL
    # kernel stops at the padding, found by its zeros)
    dense = np.asarray(dense).astype(dtype, copy=False)
    n_rows, n_cols = dense.shape
    rows, cc, counts, values = _scan(dense)
    n_slices = (n_rows + C - 1) // C
    # each slice as wide as its longest row (at least 1), rounded up to q
    per_row = np.zeros(n_slices * C, dtype=np.int64)
    per_row[:n_rows] = counts
    longest = per_row.reshape(n_slices, C).max(axis=1)
    widths = ((np.maximum(longest, 1) + q - 1) // q * q).astype(np.int32)
    slice_ptr = np.zeros(n_slices + 1, dtype=np.int32)
    np.cumsum(widths.astype(np.int64) * C, out=slice_ptr[1:])
    total = int(slice_ptr[-1])
    data = np.zeros(total, dtype=dtype)
    cols = np.zeros(total, dtype=np.int32)
    # the k-th nonzero of row r = s*C + i lives at slice_ptr[s] + k*C + i
    k = np.arange(rows.size) - np.repeat(np.cumsum(counts) - counts, counts)
    at = slice_ptr[rows // C].astype(np.int64) + k * C + rows % C
    data[at] = values
    cols[at] = cc
    # every slot of a slice's row holds the row (each of the slice's width
    # steps holds its C rows in order); rows past the last hold n_rows
    first = np.repeat(np.arange(n_slices, dtype=np.int32) * C, widths)
    row_ids = np.minimum(first[:, None] + np.arange(C, dtype=np.int32), n_rows).reshape(-1)
    return SELL(
        data=to_tensor(data, device),
        cols=to_tensor(cols, device),
        slice_ptr=to_tensor(slice_ptr, device),
        slice_width=to_tensor(widths, device),
        row_ids=to_tensor(row_ids, device),
        shape=(n_rows, n_cols),
        C=C,
    )


def _empty_dense(mat) -> np.ndarray:
    return np.zeros(mat.shape, dtype=_np(mat.data).dtype)


def csr_to_dense(mat: CSR) -> np.ndarray:
    out = _empty_dense(mat)
    out[_np(mat.row_ids), _np(mat.indices)] = _np(mat.data)
    return out


def ell_to_dense(mat: ELL) -> np.ndarray:
    out = _empty_dense(mat)
    n_rows = mat.shape[0]
    data, cols = _np(mat.data), _np(mat.cols)
    rows = np.repeat(np.arange(n_rows), data.shape[1])
    np.add.at(out, (rows, cols.ravel()), data.ravel())
    return out


def bell_to_dense(mat: BELL) -> np.ndarray:
    out = _empty_dense(mat)
    n_rows, n_cols = mat.shape
    data, bcols = _np(mat.data), _np(mat.block_cols)
    br, bc = mat.br, mat.bc
    for i in range(data.shape[0]):
        for j in range(data.shape[1]):
            r0, c0 = i * br, int(bcols[i, j]) * bc
            blk = data[i, j]
            rr = min(br, n_rows - r0)
            cc = min(bc, n_cols - c0)
            if rr > 0 and cc > 0:
                out[r0 : r0 + rr, c0 : c0 + cc] += blk[:rr, :cc]
    return out


def sell_to_dense(mat: SELL) -> np.ndarray:
    out = _empty_dense(mat)
    n_rows = mat.shape[0]
    rid = _np(mat.row_ids)
    valid = rid < n_rows
    np.add.at(
        out,
        (rid[valid], _np(mat.cols)[valid]),
        _np(mat.data)[valid],
    )
    return out


def from_dense(dense: np.ndarray, fmt: str, **kwargs) -> SparseFormat:
    """Convert a dense matrix to the named (registered) format.

    ``device=`` (forwarded to the converter) names where the arrays land;
    ``None`` means ``"cuda"``."""
    from repro_torch.sparse.registry import get_format

    return get_format(fmt).from_dense(dense, **kwargs)


def to_dense(mat: SparseFormat) -> np.ndarray:
    """Densify any registered format (host-side; inverse of the converters)."""
    from repro_torch.sparse.registry import spec_for

    return spec_for(mat).to_dense(mat)


def convert(mat: SparseFormat, fmt: str, **kwargs) -> SparseFormat:
    """Format-to-format conversion (via dense; host-side, timeable).

    The result stays on the source container's device unless ``device=`` says
    otherwise."""
    kwargs.setdefault("device", mat.data.device)
    return from_dense(to_dense(mat), fmt, **kwargs)


# ---------------------------------------------------------------------------
# Carrying containers across as numpy (shared storage with the reference)
# ---------------------------------------------------------------------------

_CONTAINERS = {"csr": CSR, "ell": ELL, "bell": BELL, "sell": SELL}
_ARRAY_FIELDS = {
    "csr": ("data", "indices", "indptr", "row_ids"),
    "ell": ("data", "cols"),
    "bell": ("data", "block_cols"),
    "sell": ("data", "cols", "slice_ptr", "slice_width", "row_ids"),
}
_STATIC_FIELDS = {
    "csr": ("shape",),
    "ell": ("shape",),
    "bell": ("shape", "br", "bc"),
    "sell": ("shape", "C"),
}


def container_from_numpy(
    fmt: str, arrays: dict[str, np.ndarray], *, device=None, **static
) -> SparseFormat:
    """Build a seed-format container from host arrays + static metadata.

    ``arrays`` maps the container's array field names to numpy arrays (as
    another implementation of the same storage would hand them over);
    ``static`` carries ``shape`` and the format's block/slice parameters.
    Values become float32 and indices int32 on ``device``.
    """
    device = resolve_device(device)
    if fmt not in _CONTAINERS:
        raise ValueError(f"container_from_numpy knows {tuple(_CONTAINERS)}, got {fmt!r}")
    names = _ARRAY_FIELDS[fmt]
    missing = [n for n in names if n not in arrays]
    if missing or set(static) != set(_STATIC_FIELDS[fmt]):
        raise ValueError(
            f"{fmt}: need arrays {names} and static {_STATIC_FIELDS[fmt]}; "
            f"got arrays {tuple(arrays)} and static {tuple(static)}"
        )
    static = dict(static)
    static["shape"] = tuple(int(v) for v in static["shape"])
    host = {
        n: np.asarray(arrays[n]).astype(np.float32 if n == "data" else np.int32)
        for n in names
    }
    _STORAGE_CHECKS[fmt](host, static)
    fields = {n: to_tensor(a, device) for n, a in host.items()}
    return _CONTAINERS[fmt](**fields, **static)


def _check_range(name: str, v: np.ndarray, hi: int) -> None:
    if v.size and (v.min() < 0 or v.max() >= hi):
        raise ValueError(f"{name} holds an index outside [0, {hi})")


def _check_csr(a: dict[str, np.ndarray], static: dict) -> None:
    n_rows, n_cols = static["shape"]
    nnz, ptr = a["data"].shape[0], a["indptr"]
    if (ptr.shape != (n_rows + 1,) or ptr[0] != 0 or ptr[-1] != nnz
            or (np.diff(ptr) < 0).any()):
        raise ValueError("csr.indptr is not a monotone (n_rows+1,) map onto nnz")
    if a["indices"].shape != (nnz,) or a["row_ids"].shape != (nnz,):
        raise ValueError("csr arrays disagree in length")
    _check_range("csr.indices", a["indices"], n_cols)
    _check_range("csr.row_ids", a["row_ids"], n_rows)


def _check_ell(a: dict[str, np.ndarray], static: dict) -> None:
    if a["data"].ndim != 2 or a["cols"].shape != a["data"].shape:
        raise ValueError("ell planes must be two equal (R, W) arrays")
    _check_range("ell.cols", a["cols"], static["shape"][1])


def _check_bell(a: dict[str, np.ndarray], static: dict) -> None:
    d, br, bc = a["data"], static["br"], static["bc"]
    if d.ndim != 4 or d.shape[2:] != (br, bc) or a["block_cols"].shape != d.shape[:2]:
        raise ValueError("bell.data must be (nbr, mb, br, bc) with (nbr, mb) block_cols")
    _check_range("bell.block_cols", a["block_cols"], -(-static["shape"][1] // bc))


def _check_sell(a: dict[str, np.ndarray], static: dict) -> None:
    n_rows, n_cols = static["shape"]
    C, total = static["C"], a["data"].shape[0]
    ptr, w = a["slice_ptr"], a["slice_width"]
    if (ptr.shape != (w.shape[0] + 1,) or ptr[0] != 0 or ptr[-1] != total
            or (np.diff(ptr.astype(np.int64)) != w.astype(np.int64) * C).any()):
        raise ValueError("sell.slice_ptr does not match slice_width * C")
    if a["cols"].shape != (total,) or a["row_ids"].shape != (total,):
        raise ValueError("sell arrays disagree in length")
    _check_range("sell.cols", a["cols"], n_cols)
    _check_range("sell.row_ids", a["row_ids"], n_rows + 1)  # n_rows marks padding


# Reject arrays whose indices would send a kernel out of bounds: the CUDA
# kernels gather through raw pointers and check nothing.
_STORAGE_CHECKS = {"csr": _check_csr, "ell": _check_ell, "bell": _check_bell, "sell": _check_sell}


def container_to_numpy(mat: SparseFormat) -> tuple[str, dict[str, np.ndarray], dict]:
    """Inverse of ``container_from_numpy``: ``(fmt, arrays, static)``."""
    for fmt, cls in _CONTAINERS.items():
        if type(mat) is cls:
            arrays = {n: _np(getattr(mat, n)) for n in _ARRAY_FIELDS[fmt]}
            static = {n: getattr(mat, n) for n in _STATIC_FIELDS[fmt]}
            return fmt, arrays, static
    raise TypeError(f"not a seed-format container: {type(mat).__name__}")
