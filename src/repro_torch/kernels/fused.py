"""Fused single-launch partitioned SpMV: host lowering, CUDA kernel wrapper
and its plain PyTorch version.

The sequential partitioned executor launches one kernel per row block and
concatenates the outputs; this module runs the whole heterogeneous
composite as ONE launch:

* every block's *prepared* container (CSR / ELL / BELL / SELL / plugin) is
  lowered on the host to a flat ``(values, cols, global row ids)`` nonzero
  stream — the element ORDER stays format-specific (CSR row-major, SELL
  column-major slices, BELL block panels), so the chosen format still
  determines the memory-access pattern, while padding slots (stored zeros)
  are dropped so work assignment is nnz-balanced;
* the streams are padded to one lane-aligned tile (sized from the TOTAL
  work by ``kernels.common.fused_nnz_tile``) and concatenated; a prefix-sum
  **work descriptor** ``tile_map`` tells CTA ``b`` which flat tile it owns;
* ``fused_spmv`` launches ``csrc/spmv_fused.cu`` on a CUDA tensor (``y``
  zeroed on the stream, one CTA per work item, warp-level segmented sums
  keyed on the row ids, one ``atomicAdd`` per run of equal rows) or raises;
  on a CPU tensor — and only then — it takes ``fused_spmv_plain``.

Lowering happens on the host: each block is prepared on the CPU, flattened
with numpy, and only the concatenated stream goes to the device, once.
Float atomics make ``y`` vary in its last bits from run to run.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.common import (
    KernelSchedule,
    bf16_round,
    ceil_to,
    check_operand,
    fused_nnz_tile,
    resolve_device,
)
from repro_torch.sparse.formats import BELL, CSR, ELL, SELL, _np, to_tensor


# ---------------------------------------------------------------------------
# Host-side lowering: prepared container -> flat (values, cols, rows) stream
# ---------------------------------------------------------------------------


def _flatten_csr(mat: CSR) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    return _np(mat.data), _np(mat.indices).astype(np.int32), _np(mat.row_ids).astype(np.int32)


def _flatten_ell(mat: ELL) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    data = _np(mat.data)  # (R_pad, width), row-major
    width = data.shape[1]
    rows = np.repeat(np.arange(data.shape[0], dtype=np.int32), width)
    return data.ravel(), _np(mat.cols).astype(np.int32).ravel(), rows


def _flatten_bell(mat: BELL) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    data = _np(mat.data)  # (nbr, max_blocks, br, bc), panel order
    nbr, mb, br, bc = data.shape
    rows = (
        np.arange(nbr, dtype=np.int32)[:, None, None, None] * br
        + np.arange(br, dtype=np.int32)[None, None, :, None]
    )
    cols = (
        _np(mat.block_cols).astype(np.int32)[:, :, None, None] * bc
        + np.arange(bc, dtype=np.int32)[None, None, None, :]
    )
    rows = np.broadcast_to(rows, data.shape).ravel()
    cols = np.broadcast_to(cols, data.shape).ravel()
    return data.ravel(), cols, rows


def _flatten_sell(mat: SELL) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    # column-major slice planes; padding row_ids (== n_rows) carry value 0
    # and are dropped by the caller's nonzero filter like any padding slot
    return _np(mat.data), _np(mat.cols).astype(np.int32), _np(mat.row_ids).astype(np.int32)


# dispatch by container type, as the reference's isinstance chain does
_FLATTENERS = ((CSR, _flatten_csr), (ELL, _flatten_ell), (BELL, _flatten_bell), (SELL, _flatten_sell))


def flatten_block(mat, row_start: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lower one block's prepared container to its flat nonzero stream.

    Returns ``(values, cols, rows)`` with rows in GLOBAL coordinates
    (``row_start`` added). Padding slots — stored zeros, whatever layout the
    format keeps them in — are filtered out, so the stream length is the
    block's nnz and fused work assignment is nnz-balanced. Plugin containers
    without a dedicated lowering densify through their registered
    ``to_dense`` and flatten as COO.
    """
    for cls, flatten in _FLATTENERS:
        if isinstance(mat, cls):
            data, cols, rows = flatten(mat)
            break
    else:
        from repro_torch.sparse.registry import spec_for

        dense = np.asarray(spec_for(mat).to_dense(mat))
        rows, cols = np.nonzero(dense)
        data = dense[rows, cols]
        rows, cols = rows.astype(np.int32), cols.astype(np.int32)
    keep = data != 0
    return (
        np.ascontiguousarray(data[keep]),
        np.ascontiguousarray(cols[keep]),
        np.ascontiguousarray(rows[keep] + np.int32(row_start)),
    )


# ---------------------------------------------------------------------------
# The single-launch kernel: wrapper + plain version
# ---------------------------------------------------------------------------


def fused_spmv_plain(
    data: torch.Tensor,
    cols: torch.Tensor,
    rows: torch.Tensor,
    tile_map: torch.Tensor,
    x: torch.Tensor,
    n_rows: int,
    tile: int,
    *,
    unroll: int = 1,
    accum_dtype: str = "float32",
) -> torch.Tensor:
    """Gather the tiles ``tile_map`` names, multiply, ``index_add_`` into an
    ``(n_rows + 1,)`` float32 ``y`` (spill slot last). bf16: operands and
    products rounded to bf16, the sum taken in float32 and rounded once."""
    del unroll  # a loop-shape knob of the kernel only
    idx = (tile_map.long()[:, None] * tile + torch.arange(tile, device=x.device)).reshape(-1)
    d, c, r = data[idx], cols[idx].long(), rows[idx].long()
    bf16 = accum_dtype == "bfloat16"
    xg = x[c]
    prods = bf16_round(bf16_round(d) * bf16_round(xg)) if bf16 else d * xg
    y = torch.zeros(n_rows + 1, dtype=torch.float32, device=x.device)
    y.index_add_(0, r, prods)
    return bf16_round(y) if bf16 else y


def fused_spmv(
    data: torch.Tensor,
    cols: torch.Tensor,
    rows: torch.Tensor,
    tile_map: torch.Tensor,
    x: torch.Tensor,
    n_rows: int,
    tile: int,
    *,
    unroll: int = 1,
    accum_dtype: str = "float32",
) -> torch.Tensor:
    """One launch over the fused composite stream.

    ``data/cols/rows: (n_tiles * tile,)``; padding entries carry value 0,
    col 0, row ``n_rows`` (the spill slot). ``tile_map: (n_tiles,)`` is the
    prefix-sum work descriptor: CTA ``b`` processes flat tile
    ``tile_map[b]``. Returns ``y: (n_rows + 1,)`` (spill slot last)."""
    dev = x.device
    check_operand(x, "x", torch.float32, 1, dev)
    check_operand(data, "data", torch.float32, 1, dev)
    check_operand(cols, "cols", torch.int32, 1, dev)
    check_operand(rows, "rows", torch.int32, 1, dev)
    check_operand(tile_map, "tile_map", torch.int32, 1, dev)
    n_tiles = int(tile_map.shape[0])
    if data.shape[0] != n_tiles * tile or cols.shape != data.shape or rows.shape != data.shape:
        raise ValueError(
            f"stream length {data.shape[0]} != n_tiles*tile {n_tiles * tile}"
        )
    if dev.type == "cpu":
        return fused_spmv_plain(
            data, cols, rows, tile_map, x, n_rows, tile,
            unroll=unroll, accum_dtype=accum_dtype,
        )
    if dev.type != "cuda":
        raise RuntimeError(f"fused_spmv has no kernel for device {dev}")
    from repro_torch.kernels.build import bind, check_launch

    y = torch.empty(n_rows + 1, dtype=torch.float32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = bind("spmv_fused", "spmv_fused_launch", [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp])
    with torch.cuda.device(dev):
        err = fn(
            data.data_ptr(), cols.data_ptr(), rows.data_ptr(), tile_map.data_ptr(),
            x.data_ptr(), y.data_ptr(), n_tiles, tile, n_rows, unroll,
            int(accum_dtype == "bfloat16"),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(err, "fused_spmv")
    fused_spmv.launches += 1
    return y


fused_spmv.launches = 0  # kernel launches made by this process


# ---------------------------------------------------------------------------
# Lowering a CompositePlan -> FusedSpmv
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class FusedSpmv:
    """A composite plan lowered to one launch-ready fused stream."""

    data: torch.Tensor  # (n_tiles * tile,)
    cols: torch.Tensor  # (n_tiles * tile,) int32
    rows: torch.Tensor  # (n_tiles * tile,) int32, == n_rows on padding
    tile_map: torch.Tensor  # (n_tiles,) int32 work descriptor
    block_of_tile: tuple[int, ...]  # owning block index per work item
    formats: tuple[str, ...]  # per-block formats the streams were lowered from
    n_rows: int
    tile: int
    unroll: int
    accum_dtype: str
    device: torch.device

    @property
    def n_tiles(self) -> int:
        return int(self.tile_map.shape[0])

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device).contiguous()
        y = fused_spmv(
            self.data, self.cols, self.rows, self.tile_map, x, self.n_rows, self.tile,
            unroll=self.unroll, accum_dtype=self.accum_dtype,
        )
        return y[: self.n_rows]


def fused_schedule_params(schedules: list[KernelSchedule], tile: int) -> tuple[int, str]:
    """(unroll, accum_dtype) for the fused stream: the most conservative of
    the per-block schedules — smallest unroll that divides the tile, and
    float32 accumulation unless EVERY block asked for bfloat16."""
    unroll = min((s.unroll for s in schedules), default=1)
    while tile % unroll:
        unroll //= 2
    accum = (
        "bfloat16"
        if schedules and all(s.accum_dtype == "bfloat16" for s in schedules)
        else "float32"
    )
    return max(unroll, 1), accum


def lower_fused(dense: np.ndarray, plan, *, device=None) -> FusedSpmv:
    """Lower every block of a ``CompositePlan`` into one fused stream.

    Each block's dense rows are prepared on the CPU in the block's chosen
    format (the same conversion the sequential executor performs, without
    a device copy per block), flattened with ``flatten_block``, padded to
    the common tile (value 0 / col 0 / row ``n_rows`` spill entries), and
    concatenated; the work descriptor comes from the prefix sums of the
    per-block tile counts. Only the four concatenated arrays go to
    ``device``.
    """
    from repro_torch.kernels.ops import prepare  # lazy: ops imports this module

    device = resolve_device(device)
    dense = np.asarray(dense)
    n_rows = plan.partition.n_rows
    streams = []
    for bp in plan.blocks:
        block = dense[bp.block.row_start : bp.block.row_end]
        mat = prepare(block, bp.fmt, bp.schedule, device="cpu")
        streams.append(flatten_block(mat, bp.block.row_start))
        del mat

    total = sum(d.size for d, _, _ in streams)
    tile = fused_nnz_tile(max(total, 1))
    val_dtype = streams[0][0].dtype if streams else np.float32

    datas, colss, rowss = [], [], []
    block_tiles: list[int] = []
    for d, c, r in streams:
        padded = ceil_to(d.size, tile)  # empty block -> zero tiles
        datas.append(np.pad(d, (0, padded - d.size)))
        colss.append(np.pad(c, (0, padded - c.size)))
        rowss.append(np.pad(r, (0, padded - r.size), constant_values=n_rows))
        block_tiles.append(padded // tile)
    if sum(block_tiles) == 0:  # fully empty matrix: one all-spill tile
        datas.append(np.zeros(tile, dtype=val_dtype))
        colss.append(np.zeros(tile, dtype=np.int32))
        rowss.append(np.full(tile, n_rows, dtype=np.int32))
        block_tiles[0] = 1

    # prefix-sum work descriptor: CTA id -> (block, tile) work item, laid
    # out as the flat tile index block_offset[b] + local tile
    offsets = np.concatenate([[0], np.cumsum(block_tiles)]).astype(np.int32)
    tile_map = np.concatenate(
        [offsets[b] + np.arange(k, dtype=np.int32) for b, k in enumerate(block_tiles)]
    )
    block_of_tile = tuple(int(b) for b, k in enumerate(block_tiles) for _ in range(k))

    unroll, accum = fused_schedule_params([bp.schedule for bp in plan.blocks], tile)
    return FusedSpmv(
        data=to_tensor(np.concatenate(datas).astype(np.float32), device),
        cols=to_tensor(np.concatenate(colss).astype(np.int32), device),
        rows=to_tensor(np.concatenate(rowss).astype(np.int32), device),
        tile_map=to_tensor(tile_map, device),
        block_of_tile=block_of_tile,
        formats=tuple(bp.fmt for bp in plan.blocks),
        n_rows=n_rows,
        tile=tile,
        unroll=unroll,
        accum_dtype=accum,
        device=device,
    )
