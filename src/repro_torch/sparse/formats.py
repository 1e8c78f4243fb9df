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

from dataclasses import dataclass
from typing import Union

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


def _row_counts(dense: np.ndarray) -> np.ndarray:
    return (dense != 0).sum(axis=1).astype(np.int64)


def csr_from_dense(dense: np.ndarray, dtype=np.float32, *, device=None) -> CSR:
    device = resolve_device(device)
    dense = np.asarray(dense)
    n_rows, n_cols = dense.shape
    rows, cols = np.nonzero(dense)
    data = dense[rows, cols].astype(dtype)
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
    dense = np.asarray(dense)
    n_rows, n_cols = dense.shape
    counts = _row_counts(dense)
    width = max(int(counts.max(initial=0)), min_width)
    data = np.zeros((n_rows, width), dtype=dtype)
    cols = np.zeros((n_rows, width), dtype=np.int32)
    rows, cc = np.nonzero(dense)
    # position of each nonzero within its row
    pos = np.arange(rows.size) - np.repeat(np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    data[rows, pos] = dense[rows, cc]
    cols[rows, pos] = cc
    return ELL(
        data=to_tensor(data, device),
        cols=to_tensor(cols, device),
        shape=(n_rows, n_cols),
    )


def bell_from_dense(
    dense: np.ndarray, br: int = SUBLANE, bc: int = LANE, dtype=np.float32, *, device=None
) -> BELL:
    device = resolve_device(device)
    dense = np.asarray(dense)
    n_rows, n_cols = dense.shape
    pr, pc = _ceil_to(n_rows, br), _ceil_to(n_cols, bc)
    padded = np.zeros((pr, pc), dtype=dtype)
    padded[:n_rows, :n_cols] = dense
    nbr, nbc = pr // br, pc // bc
    blocks = padded.reshape(nbr, br, nbc, bc).transpose(0, 2, 1, 3)  # (nbr, nbc, br, bc)
    occupied = (blocks != 0).any(axis=(2, 3))  # (nbr, nbc)
    max_blocks = max(int(occupied.sum(axis=1).max(initial=0)), 1)
    data = np.zeros((nbr, max_blocks, br, bc), dtype=dtype)
    block_cols = np.zeros((nbr, max_blocks), dtype=np.int32)
    for i in range(nbr):
        js = np.nonzero(occupied[i])[0]
        data[i, : js.size] = blocks[i, js]
        block_cols[i, : js.size] = js
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
    dense = np.asarray(dense)
    n_rows, n_cols = dense.shape
    counts = _row_counts(dense)
    n_slices = (n_rows + C - 1) // C
    widths = np.zeros(n_slices, dtype=np.int32)
    for s in range(n_slices):
        w = int(counts[s * C : (s + 1) * C].max(initial=0))
        widths[s] = _ceil_to(max(w, 1), q)
    slice_ptr = np.zeros(n_slices + 1, dtype=np.int32)
    np.cumsum(widths.astype(np.int64) * C, out=slice_ptr[1:])
    total = int(slice_ptr[-1])
    data = np.zeros(total, dtype=dtype)
    cols = np.zeros(total, dtype=np.int32)
    row_ids = np.full(total, n_rows, dtype=np.int32)
    for s in range(n_slices):
        w = int(widths[s])
        base = int(slice_ptr[s])
        # build the (C, w) slice plane row-major, then store transposed
        plane_d = np.zeros((C, w), dtype=dtype)
        plane_c = np.zeros((C, w), dtype=np.int32)
        plane_r = np.full((C, w), n_rows, dtype=np.int32)
        for r_local in range(min(C, n_rows - s * C)):
            r = s * C + r_local
            cc = np.nonzero(dense[r])[0]
            plane_d[r_local, : cc.size] = dense[r, cc]
            plane_c[r_local, : cc.size] = cc
            plane_r[r_local, :] = r
        data[base : base + C * w] = plane_d.T.ravel()
        cols[base : base + C * w] = plane_c.T.ravel()
        row_ids[base : base + C * w] = plane_r.T.ravel()
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
