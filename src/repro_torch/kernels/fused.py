"""Fused single-launch partitioned SpMV: host lowering, its launch plan, the
CUDA kernel wrapper and its plain PyTorch version.

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
  **work descriptor** ``tile_map`` names the flat tiles in the order they
  are taken;
* ``fused_launch_plan`` (integers only, built once by ``lower_fused`` from
  the host arrays) cuts the tiles into pieces, one CTA each, sized from the
  stream length and the SM count and cut where a piece's row window would
  exceed ``FUSED_WINDOW`` rows; it says which piece stores each row, where
  the partials of rows shared by several pieces go, which piece stores the
  rows no piece touches, and each element's row as a byte, its offset into
  its piece's window (the kernel reads those, not the row ids);
* ``fused_spmv`` launches ``csrc/spmv_fused.cu`` on a CUDA tensor (sums in
  shared-memory row windows, fixed order, no atomics on ``y``: two launches
  give the same bits) or raises; on a CPU tensor — and only then — it takes
  ``fused_spmv_plain``.

Lowering happens on the host: each block is prepared on the CPU, flattened
with numpy, and only the concatenated stream and the plan's two arrays go
to the device, once.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.common import (
    H100_SMS,
    KernelSchedule,
    bf16_round,
    ceil_to,
    check_operand,
    fused_nnz_tile,
    resolve_device,
    sm_count,
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
# The launch plan: pieces, row windows, shared rows, zero rows
# ---------------------------------------------------------------------------

# shared with csrc/spmv_fused.cu's spmv_fused_constants: threads per CTA,
# rows of a piece's window, sub-steps of 32 elements per warp and trip, ints
# per piece and per group in the packed plan, resident CTAs per SM (the
# kernel's launch bounds hold it to 64 registers a thread)
FUSED_THREADS = 256
FUSED_WINDOW = 255
FUSED_STEPS = 4
FUSED_PIECE_INTS = 8
FUSED_GROUP_INTS = 4
FUSED_CTAS_PER_SM = 4
# the fewest live elements a piece is cut to: one per thread of its CTA
FUSED_MIN_PIECE = FUSED_THREADS
# rows of zeros one CTA stores at most per zero run
FUSED_ZERO_RUN = 4096
# window codes: the piece stores the row itself / does not touch it; a code
# >= 0 is the scratch slot of the piece's partial of a shared row
FUSED_DIRECT, FUSED_SKIP = -1, -2
# window row of a padding element (window rows are bytes)
FUSED_PAD_ROW = 0xFF
# elements of one 16-byte unit of window rows: the kernel's bulk copies move
# whole units, so a stream's tile is a multiple of it
FUSED_ALIGN = 16
# pieces per SM the plan cuts a stream into (one CTA each); the kernel's
# launch bounds let FUSED_CTAS_PER_SM reside, so a few tiles' rounding and
# the window cuts still fit one wave
FUSED_PIECES_PER_SM = 2


def fused_piece_len(live: int, n_sms: int) -> int:
    """Live elements per piece: the stream's live elements over
    ``FUSED_PIECES_PER_SM`` pieces per SM, at least ``FUSED_MIN_PIECE``, in
    whole warp sub-steps."""
    per = -(-int(live) // (FUSED_PIECES_PER_SM * max(int(n_sms), 1)))
    return ceil_to(max(per, FUSED_MIN_PIECE), 32)


def _cut_windows(lo: np.ndarray, hi: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                 window: int) -> np.ndarray:
    """Further piece starts inside ``[starts, ends)`` wherever a piece's row
    window (``lo``/``hi``: the element's row, or +inf / -1 on padding) would
    exceed ``window`` rows: each piece grows element by element and a new
    one begins at the first element that does not fit."""
    extra = []
    for s, e in zip(starts.tolist(), ends.tolist()):
        p = s
        while True:
            cmax = np.maximum.accumulate(hi[p:e]).astype(np.int64)
            cmin = np.minimum.accumulate(lo[p:e]).astype(np.int64)
            over = np.flatnonzero((cmax >= 0) & (cmax - cmin + 1 > window))
            if not over.size:
                break
            p += int(over[0])
            extra.append(p)
    return np.asarray(extra, dtype=np.int64)


def fused_launch_plan(rows, tile_map, tile: int, n_rows: int, n_sms: int, *,
                      piece: int | None = None) -> dict:
    """B5's launch from the host stream's row ids and work descriptor, with
    integers only (a launch copies nothing from the device).

    * Pieces. The tiles are taken in ``tile_map`` order; the live part of
      each is cut into equal pieces of whole 32-element sub-steps, as many
      as pieces of about ``piece`` live elements (``fused_piece_len`` unless
      given: ``FUSED_PIECES_PER_SM`` pieces per SM, at least
      ``FUSED_MIN_PIECE``), and a piece is cut again wherever its row window
      (max row - min row + 1, padding excluded) would exceed
      ``FUSED_WINDOW``. The padding tail of a tile belongs to its last piece
      and is not read (``live`` stops at the last real element).
    * Rows. A row that one piece alone touches is stored by it
      (``FUSED_DIRECT``). Rows touched by several pieces form groups, one per
      set of pieces; piece q of a group of g pieces and m rows stores its
      partial of the group's j-th row at scratch slot ``base + q * m + j``,
      and the last of the g to take the group's ticket adds them in piece
      order. Rows no piece touches, and the spill slot ``n_rows``, lie in
      zero runs of at most ``FUSED_ZERO_RUN`` rows; piece ``z % ctas``
      stores run z.

    * Window rows. ``window_rows`` holds each stream element's row as an
      offset into its piece's window (a byte; ``FUSED_PAD_ROW`` for
      padding): the kernel reads this 1 byte per element instead of the
      4-byte row id (a tile named twice in ``tile_map`` is cut the same way
      each time, so every element has one offset).

    Returns the plan's integers and arrays, and ``packed``: one int32 array
    in the kernel's layout (``FUSED_PIECE_INTS`` per piece, then the window
    codes, the pieces' groups, ``FUSED_GROUP_INTS`` per group, the groups'
    rows and the zero runs, at ``offsets``)."""
    rows = np.asarray(rows).astype(np.int32, copy=False).reshape(-1)
    tmap = np.asarray(tile_map).astype(np.int64, copy=False).reshape(-1)
    tile, n_rows, n_tiles = int(tile), int(n_rows), int(tmap.size)
    if (tile < 1 or tile % FUSED_ALIGN or rows.size != n_tiles * tile or n_rows < 0
            or rows.size >= 2**31):
        raise ValueError(f"no fused launch for {rows.size} elements in {n_tiles} tiles "
                         f"of {tile}, {n_rows} rows")
    if n_tiles and (tmap.min() < 0 or tmap.max() >= n_tiles):
        raise ValueError("tile_map names a tile outside the stream")
    # the stream in the order its pieces take it: tile_map's tiles in turn
    ordered = np.array_equal(tmap, np.arange(n_tiles))
    rv = rows if ordered else rows.reshape(n_tiles, tile)[tmap].reshape(-1)
    real = rv != n_rows
    if ((rv[real] < 0) | (rv[real] > n_rows)).any():
        raise ValueError(f"a row id lies outside 0..{n_rows}")
    n_live = int(real.sum())
    piece = int(piece) if piece is not None else fused_piece_len(n_live, n_sms)
    if piece < 1:
        raise ValueError(f"no fused launch for pieces of {piece} elements")

    # ---- pieces: each tile's live part cut, then cut again where a window is too wide
    if n_tiles == 0:
        starts = np.zeros(1, np.int64)
        ends = np.zeros(1, np.int64)
    else:
        real2 = real.reshape(n_tiles, tile)
        has = real2.any(axis=1)
        last = np.where(has, tile - 1 - np.argmax(real2[:, ::-1], axis=1), -1)
        # a tile's live part in equal pieces of whole sub-steps, none left short
        n_cut = np.maximum(1, (last + 1 + piece // 2) // piece)
        step = np.maximum(ceil_to(-(-(last + 1) // n_cut), 32), 32)
        n_cut = np.maximum(1, -(-(last + 1) // step))
        first = np.cumsum(n_cut) - n_cut
        k = np.arange(int(n_cut.sum())) - np.repeat(first, n_cut)
        starts = (np.repeat(np.arange(n_tiles, dtype=np.int64), n_cut) * tile
                  + k * np.repeat(step, n_cut))
        lo = np.where(real, rv, np.iinfo(np.int32).max)
        hi = np.where(real, rv, -1)
        ends = np.append(starts[1:], rv.size)
        wide = (np.maximum.reduceat(hi, starts).astype(np.int64)
                - np.minimum.reduceat(lo, starts) + 1) > FUSED_WINDOW
        if wide.any():
            starts = np.sort(np.concatenate(
                [starts, _cut_windows(lo, hi, starts[wide], ends[wide], FUSED_WINDOW)]))
            ends = np.append(starts[1:], rv.size)
    n_pieces = int(starts.size)
    lengths = ends - starts
    if rv.size:
        mn = np.minimum.reduceat(np.where(real, rv, np.iinfo(np.int32).max), starts)
        mx = np.maximum.reduceat(np.where(real, rv, -1), starts)
        last_real = np.maximum.reduceat(np.where(real, np.arange(rv.size), -1), starts)
    else:
        mn = mx = last_real = np.full(n_pieces, -1)
    touched = mx >= 0
    rlo = np.where(touched, mn, 0).astype(np.int64)
    width = np.where(touched, mx.astype(np.int64) - mn + 1, 0)
    live = np.where(last_real >= 0, last_real + 1 - starts, 0)
    tile_of = starts // tile
    stream_start = tmap[tile_of] * tile + starts - tile_of * tile if n_tiles else starts

    # ---- which pieces touch each row: one mark per (piece, window row)
    table_off = np.cumsum(width) - width
    n_table = int(width.sum())
    ri = np.flatnonzero(real)
    pr = np.searchsorted(starts, ri, side="right") - 1
    local = rv[ri] - rlo[pr]
    mark = np.zeros(n_table, bool)
    mark[table_off[pr] + local] = True
    window_rows = np.full(rows.size, FUSED_PAD_ROW, np.uint8)
    window_rows[ri if ordered else tmap[ri // tile] * tile + ri % tile] = local
    tpiece = np.repeat(np.arange(n_pieces), width)
    trow = rlo[tpiece] + np.arange(n_table) - table_off[tpiece]
    e = np.flatnonzero(mark)
    er, ep = trow[e], tpiece[e]
    count = np.bincount(er, minlength=n_rows)[:n_rows]
    codes = np.full(n_table, FUSED_SKIP, np.int64)
    codes[e[count[er] == 1]] = FUSED_DIRECT

    # ---- shared rows: grouped by the set of pieces that touch them
    sh = count[er] >= 2
    order = np.lexsort((ep[sh], er[sh]))
    se, sr, sp = e[sh][order], er[sh][order], ep[sh][order]
    urows, ustart, ucount = np.unique(sr, return_index=True, return_counts=True)
    group_of_set: dict[bytes, int] = {}
    group_pieces: list[np.ndarray] = []
    row_group = np.empty(urows.size, np.int64)
    for i, (a, c) in enumerate(zip(ustart.tolist(), ucount.tolist())):
        key = sp[a : a + c].tobytes()
        g = group_of_set.get(key)
        if g is None:
            g = group_of_set[key] = len(group_pieces)
            group_pieces.append(sp[a : a + c])
        row_group[i] = g
    n_groups = len(group_pieces)
    g_m = np.bincount(row_group, minlength=n_groups)
    g_n = np.array([p.size for p in group_pieces], np.int64)
    g_roff = np.cumsum(g_m) - g_m
    g_base = np.cumsum(g_m * g_n) - g_m * g_n
    by_group = np.argsort(row_group, kind="stable")  # rows of a group ascending
    row_rank = np.empty(urows.size, np.int64)
    row_rank[by_group] = np.arange(urows.size) - g_roff[row_group[by_group]]
    u_of = np.repeat(np.arange(urows.size), ucount)
    q = np.arange(sr.size) - np.repeat(ustart, ucount)  # piece's rank in its group
    gi = row_group[u_of]
    codes[se] = g_base[gi] + q * g_m[gi] + row_rank[u_of]
    group_rows = urows[by_group]
    gp_piece = np.concatenate(group_pieces) if n_groups else np.zeros(0, np.int64)
    gp_group = np.repeat(np.arange(n_groups), g_n)
    by_piece = np.lexsort((gp_group, gp_piece))
    piece_groups = gp_group[by_piece]
    piece_group_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(gp_piece, minlength=n_pieces))])

    # ---- rows no piece touches, and the spill slot: zero runs
    zero = np.append(np.flatnonzero(count == 0), n_rows)
    breaks = np.flatnonzero(np.diff(zero) != 1) + 1
    run_lo = zero[np.concatenate([[0], breaks])]
    run_hi = zero[np.append(breaks - 1, zero.size - 1)] + 1
    n_split = -(-(run_hi - run_lo) // FUSED_ZERO_RUN)
    z_lo = np.repeat(run_lo, n_split) + FUSED_ZERO_RUN * (
        np.arange(int(n_split.sum())) - np.repeat(np.cumsum(n_split) - n_split, n_split))
    zero_runs = np.stack([z_lo, np.minimum(z_lo + FUSED_ZERO_RUN,
                                           np.repeat(run_hi, n_split))], axis=1)

    # ---- the kernel's layout
    pieces_packed = np.stack([stream_start, live, rlo, width, table_off,
                              piece_group_ptr[:-1], piece_group_ptr[1:],
                              np.zeros(n_pieces, np.int64)], axis=1)
    groups = np.stack([g_roff, g_m, g_n, g_base], axis=1).reshape(-1, FUSED_GROUP_INTS)
    parts = [pieces_packed.ravel(), codes, piece_groups, groups.ravel(), group_rows,
             zero_runs.ravel()]
    bounds = np.cumsum([0] + [p.size for p in parts])
    scratch = int((g_m * g_n).sum())
    if bounds[-1] >= 2**31 or scratch >= 2**31:
        raise ValueError("fused launch plan too large for 32-bit offsets")
    packed = np.concatenate(parts).astype(np.int32)
    return {
        "piece": piece, "ctas": n_pieces, "n_rows": n_rows, "stream_len": int(rows.size),
        "pieces": np.stack([stream_start, lengths, live], axis=1),
        "rlo": rlo, "width": width, "table_off": table_off, "codes": codes,
        "groups": groups, "group_rows": group_rows, "piece_group_ptr": piece_group_ptr,
        "piece_groups": piece_groups, "zero_runs": zero_runs, "window_rows": window_rows,
        "max_window": int(width.max(initial=0)), "shared_rows": int(urows.size),
        "n_groups": n_groups, "scratch": scratch, "writes": n_rows + 1 + scratch,
        "packed": packed,
        "offsets": {k: int(b) for k, b in zip(("table", "pgroups", "groups", "grows", "zero"),
                                              bounds[1:6])},
    }


def fused_plan_summary(plan: dict) -> dict:
    """The plan's integers, without its arrays (for logs)."""
    return {k: plan[k] for k in ("ctas", "piece", "max_window", "shared_rows", "n_groups",
                                 "scratch", "writes")} | {"zero_runs": len(plan["zero_runs"])}


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


# scratch per (device, stream): group tickets (zero between launches: the
# kernel resets each one it uses) and the partials of shared rows
_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(dev: torch.device, stream: int, tickets: int, floats: int) -> tuple[int, int]:
    """Pointers to ``tickets`` zeroed int32 tickets and ``floats`` float32
    partial slots, kept per (device, stream) and replaced by larger buffers
    when a launch needs more."""
    key = (dev.index, stream)
    t, p = _SCRATCH.get(key, (None, None))
    if t is None or t.shape[0] < tickets:
        t = torch.zeros(max(tickets, 1024), dtype=torch.int32, device=dev)
    if p is None or p.shape[0] < floats:
        p = torch.empty(max(floats, 4096), dtype=torch.float32, device=dev)
    _SCRATCH[key] = (t, p)
    return t.data_ptr(), p.data_ptr()


def plan_buffers(plan: dict, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The plan's packed array and window rows on ``device`` (int32 and
    uint8), kept in the plan under ``"buffers"``."""
    bufs = plan.get("buffers")
    if bufs is None or bufs[0].device != device:
        bufs = plan["buffers"] = (to_tensor(plan["packed"], device),
                                  to_tensor(plan["window_rows"], device))
    return bufs


def _fused_launch(
    data: torch.Tensor,
    cols: torch.Tensor,
    x: torch.Tensor,
    plan: dict,
    *,
    unroll: int = 1,
    accum_dtype: str = "float32",
    writes: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch B5 at ``plan`` on checked CUDA operands (the plan's window
    rows stand for the stream's row ids); ``y``. With
    ``writes`` (int32, one per CTA) each CTA stores its count of global
    stores there. The launch counter is the wrapper's, not this helper's:
    ``chip_smoke.py`` runs checks through here without moving it."""
    from repro_torch.kernels.build import bind, check_launch

    dev = x.device
    n_rows = plan["n_rows"]
    y = torch.empty(n_rows + 1, dtype=torch.float32, device=dev)
    packed, window_rows = plan_buffers(plan, dev)
    off = plan["offsets"]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = bind("spmv_fused", "spmv_fused_launch", [vp] * 6 + [ci] * 8 + [vp] * 3 + [ci] * 2 + [vp])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets, partials = _scratch(dev, stream, plan["n_groups"], plan["scratch"])
        err = fn(
            data.data_ptr(), cols.data_ptr(), window_rows.data_ptr(), x.data_ptr(), y.data_ptr(),
            packed.data_ptr(), plan["ctas"], off["table"], off["pgroups"], off["groups"],
            off["grows"], off["zero"], len(plan["zero_runs"]), n_rows, tickets, partials,
            None if writes is None else writes.data_ptr(), unroll,
            int(accum_dtype == "bfloat16"), stream,
        )
    check_launch(err, "fused_spmv")
    return y


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
    plan: dict | None = None,
) -> torch.Tensor:
    """One launch over the fused composite stream.

    ``data/cols/rows: (n_tiles * tile,)``; padding entries carry value 0,
    col 0, row ``n_rows`` (the spill slot). ``tile_map: (n_tiles,)`` is the
    prefix-sum work descriptor: the flat tiles in the order they are taken.
    ``plan`` is the stream's ``fused_launch_plan`` (``lower_fused`` keeps
    one); without it a CUDA call builds one from the stream, copying
    ``rows`` and ``tile_map`` to the host. Returns ``y: (n_rows + 1,)``
    (spill slot last, 0)."""
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
    if plan is not None and (plan["stream_len"] != data.shape[0] or plan["n_rows"] != n_rows):
        raise ValueError(f"the plan is for {plan['stream_len']} elements and "
                         f"{plan['n_rows']} rows, the stream has {data.shape[0]} and {n_rows}")
    if dev.type == "cpu":
        return fused_spmv_plain(
            data, cols, rows, tile_map, x, n_rows, tile,
            unroll=unroll, accum_dtype=accum_dtype,
        )
    if dev.type != "cuda":
        raise RuntimeError(f"fused_spmv has no kernel for device {dev}")
    if plan is None:
        plan = fused_launch_plan(rows.cpu().numpy(), tile_map.cpu().numpy(), tile, n_rows,
                                 sm_count(dev))
    y = _fused_launch(data, cols, x, plan, unroll=unroll, accum_dtype=accum_dtype)
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
    launch_plan: dict  # fused_launch_plan of the stream, with its device buffers

    @property
    def n_tiles(self) -> int:
        return int(self.tile_map.shape[0])

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device).contiguous()
        y = fused_spmv(
            self.data, self.cols, self.rows, self.tile_map, x, self.n_rows, self.tile,
            unroll=self.unroll, accum_dtype=self.accum_dtype, plan=self.launch_plan,
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
    per-block tile counts, the launch plan from the concatenated row ids and
    the descriptor (``fused_launch_plan``, for the device's SM count; on the
    CPU for an H100's). Only the four concatenated arrays and the packed
    plan go to ``device``.
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
    rows = np.concatenate(rowss).astype(np.int32)
    n_sms = sm_count(device) if device.type == "cuda" else H100_SMS
    launch_plan = fused_launch_plan(rows, tile_map, tile, n_rows, n_sms)
    plan_buffers(launch_plan, device)
    return FusedSpmv(
        data=to_tensor(np.concatenate(datas).astype(np.float32), device),
        cols=to_tensor(np.concatenate(colss).astype(np.int32), device),
        rows=to_tensor(rows, device),
        tile_map=to_tensor(tile_map, device),
        block_of_tile=block_of_tile,
        formats=tuple(bp.fmt for bp in plan.blocks),
        n_rows=n_rows,
        tile=tile,
        unroll=unroll,
        accum_dtype=accum,
        device=device,
        launch_plan=launch_plan,
    )
