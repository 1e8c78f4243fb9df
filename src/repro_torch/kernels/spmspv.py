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
* **Kernel** (``csrc/spmspv_csc.cu``): ``y`` is zeroed on the stream, then
  a group of ``lanes`` lanes takes a piece of one frontier column (the
  first piece of every entry, and one more group for each further piece of
  a longer column, from the host plan ``spmspv_launch_plan``) and
  ``atomicAdd``\\ s ``value * x`` into ``y[row]``. It loops to the
  column's length (``CscEll.col_len``), so work is ``sum(col_nnz[frontier])``,
  not ``k * W``, and a hub column is spread over many groups. The frontier
  length ``k`` is a runtime argument: nothing is padded to a power of two
  (``_frontier_pad`` stays for parity with the reference only). Float
  atomics make ``y`` vary in its last bits from run to run.

``csc_spmspv`` is the frontier-level wrapper (validation, empty-frontier
short cut, the plan from the host copy of the column lengths, one copy of
frontier and pieces to the device, made by the launch, spill slot
truncated). On a CUDA container it launches the kernel or raises; on a
CPU container — and only then — it takes ``csc_spmspv_plain``.
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
    sm_count,
)


# B6's launch (csrc/spmspv_csc.cu): a group of G lanes owns a piece of a
# column and loads SPMSPV_SLOTS slots a lane per trip; a piece is a whole
# number of trips (one by default); a CTA holds at most 8 warps. The
# kernel's ``spmspv_csc_constants`` returns the slots per lane and the most
# warps per CTA, and its entry point refuses a grid that does not cover the
# plan's pieces.
SPMSPV_SLOTS = 8
SPMSPV_LANE_GROUPS = (4, 8, 16, 32)  # lanes per piece, each a template instance
SPMSPV_CTA_WARPS = (1, 2, 4, 8)
# the most lanes per piece while the frontier's warps stay within this many
# per SM
SPMSPV_TARGET_WARPS_PER_SM = 16
# the plan lists the further pieces of up to this many long entries in a
# Python loop, of more with numpy: the loop's host time grows with the
# pieces, numpy's is a larger fixed cost (chip_smoke.py times both at the
# solve breakdown's frontiers, `plan_paths_ms`). The frontiers a solver
# sends B6 hold a few long columns, and the wrapper's host time is most of
# a call.
SPMSPV_FEW_LONG = 8
_NO_PIECES = np.zeros((0, 2), dtype=np.int32)  # the plan's pieces where no column is long
_NO_PIECES.flags.writeable = False


@dataclass(frozen=True, eq=False)
class CscEll:
    """Column-major ELL: padded per-column slices, kernel-ready for SpMSpV.

    ``data[c]`` / ``rows[c]`` hold column ``c``'s nonzero values and row
    ids, zero-/spill-padded to the shared width. Row index ``n_rows`` is the
    spill row (padding slots); column index ``n_cols`` is the spill column
    (frontier padding) — all-zero by construction. ``nbytes`` counts the two
    planes, as the reference's does.
    """

    data: torch.Tensor  # (n_cols + 1, W) values, 0 on padding slots
    rows: torch.Tensor  # (n_cols + 1, W) int32 row ids, n_rows on padding
    shape: tuple[int, int]
    # (n_cols + 1,) int32 live slots per column, 0 for the spill column: on
    # the container's device (the kernel's loop bound) and on the host (the
    # launch plan's input). Not in the reference's container.
    col_len: torch.Tensor
    col_len_host: np.ndarray

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
    col_len = np.zeros(n_cols + 1, dtype=np.int32)
    col_len[:n_cols] = counts
    return CscEll(
        data=torch.from_numpy(data).to(device),
        rows=torch.from_numpy(rows).to(device),
        shape=(n_rows, n_cols),
        col_len=torch.from_numpy(col_len).to(device),
        col_len_host=col_len,
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


def spmspv_launch_plan(lens, n_sms: int, lanes: int | None = None,
                       piece: int | None = None) -> dict:
    """B6's launch from integers only: the column lengths of the frontier's
    entries (``col_len[active]``, host integers), the card's SM count, and
    optionally the lanes per piece and the piece size (slots) to use
    instead of the rule's.

    * ``lanes`` (G): the most of ``SPMSPV_LANE_GROUPS`` while the ``k``
      entries' first pieces, ``32 / G`` to a warp, stay within
      ``SPMSPV_TARGET_WARPS_PER_SM`` warps per SM.
    * ``piece`` (H): one trip of the group, ``G * SPMSPV_SLOTS`` slots, or a
      whole number of trips.
    * Every entry's first piece is a group; an entry of ``L > H`` slots gets
      ``(L - 1) // H`` further groups, listed in ``pieces`` as
      ``(entry, start)`` rows (int32, starts ``H, 2 * H, ...``) and
      launched first. A frontier with no long column costs one comparison
      of its lengths and lists nothing.
    * ``warps_per_cta``: the most of ``SPMSPV_CTA_WARPS`` that still gives
      every SM a CTA, so a small frontier's warps spread over the SMs.
    """
    lens = np.asarray(lens)
    if lens.ndim != 1 or (lens.size and lens.dtype.kind not in "iu"):
        raise ValueError("spmspv_launch_plan takes a 1-D integer array of column lengths")
    k, n_sms = lens.size, int(n_sms)
    lanes = spmspv_lanes(k, n_sms) if lanes is None else int(lanes)
    piece = lanes * SPMSPV_SLOTS if piece is None else int(piece)
    if lanes not in SPMSPV_LANE_GROUPS or piece < 1 or piece % (lanes * SPMSPV_SLOTS) or n_sms < 1:
        raise ValueError(f"no SpMSpV launch for lanes={lanes}, piece={piece}, n_sms={n_sms}")
    long = np.flatnonzero(lens > piece)
    if not long.size:
        pieces = _NO_PIECES
    elif long.size > SPMSPV_FEW_LONG:
        more = (lens[long].astype(np.int64) - 1) // piece  # further pieces per long entry
        entry = np.repeat(long, more)
        nth = np.arange(entry.size) - np.repeat(np.cumsum(more) - more, more)
        pieces = np.stack([entry, (nth + 1) * piece], axis=1).astype(np.int32)
    else:  # a few: a loop costs less host time than the numpy steps above
        flat = []
        for i, n in zip(long.tolist(), lens[long].tolist()):
            for s in range(piece, n, piece):
                flat += (i, s)
        pieces = np.array(flat, dtype=np.int32).reshape(-1, 2)
    return {**spmspv_grid(k, pieces.shape[0], lanes, piece, n_sms), "pieces": pieces}


def spmspv_lanes(k: int, n_sms: int) -> int:
    """The plan's lanes per piece for a frontier of ``k`` entries: the most
    of ``SPMSPV_LANE_GROUPS`` while the first pieces, ``32 / G`` to a warp,
    stay within ``SPMSPV_TARGET_WARPS_PER_SM`` warps per SM."""
    lanes = SPMSPV_LANE_GROUPS[0]
    for nxt in SPMSPV_LANE_GROUPS[1:]:
        if -(-int(k) * nxt // 32) > SPMSPV_TARGET_WARPS_PER_SM * int(n_sms):
            break
        lanes = nxt
    return lanes


def served_plan(mat: "CscEll", active: np.ndarray, n_sms: int) -> dict:
    """The plan of ``csc_spmspv``'s launch: ``spmspv_launch_plan`` of the
    frontier's column lengths. Where the container's width (at least its
    longest column) fits in the rule's piece, no column has a further piece
    and the lengths are not gathered."""
    k = int(active.size)
    lanes = spmspv_lanes(k, n_sms)
    if mat.width > lanes * SPMSPV_SLOTS:
        return spmspv_launch_plan(mat.col_len_host[active], n_sms, lanes)
    return {**spmspv_grid(k, 0, lanes, lanes * SPMSPV_SLOTS, n_sms), "pieces": _NO_PIECES}


def spmspv_grid(k: int, extra: int, lanes: int, piece: int, n_sms: int) -> dict:
    """The plan's grid for ``k`` first and ``extra`` further pieces of
    ``lanes`` lanes each."""
    groups = int(k) + int(extra)
    warps = -(-groups * int(lanes) // 32)
    wpc = SPMSPV_CTA_WARPS[0]
    for nxt in SPMSPV_CTA_WARPS[1:]:
        if -(-warps // nxt) < int(n_sms):
            break
        wpc = nxt
    return {"lanes": int(lanes), "piece": int(piece), "k": int(k), "extra": int(extra),
            "warps": warps, "warps_per_cta": wpc, "ctas": -(-warps // wpc)}


def spmspv_pieces(lens, plan: dict) -> np.ndarray:
    """Host twin of the kernel's groups: one ``(entry, start, length)`` row
    per piece in launch order (the plan's further pieces, then every
    entry's first piece; group q of warp w takes piece ``w * 32 / lanes +
    q``), ``length`` the slots the group loads, 0 for an empty or spill
    column."""
    lens = np.asarray(lens, dtype=np.int64)
    extra = plan["pieces"].astype(np.int64)
    entry = np.concatenate([extra[:, 0], np.arange(lens.size)])
    start = np.concatenate([extra[:, 1], np.zeros(lens.size, dtype=np.int64)])
    length = np.clip(np.minimum(start + plan["piece"], lens[entry]) - start, 0, None)
    return np.stack([entry, start, length], axis=1)


def spmspv_slots_read(lens, plan: dict) -> int:
    """Slots B6 loads under ``plan``: the sum of its pieces' lengths."""
    return int(spmspv_pieces(lens, plan)[:, 2].sum())


def csc_spmspv_kernel(
    data: torch.Tensor,
    rows: torch.Tensor,
    col_len: torch.Tensor,
    active: torch.Tensor,
    xvals: torch.Tensor,
    n_rows: int,
    schedule: KernelSchedule,
) -> torch.Tensor:
    """The kernel call on prepared operands (the reference's
    ``csc_spmspv_pallas``): ``data/rows (n_cols + 1, W)`` with
    ``W % nnz_tile == 0``; ``col_len (n_cols + 1,)`` int32 live slots per
    column; ``active (k,)`` int32 column indices (entries equal to
    ``n_cols`` hit the spill column) and ``xvals (k,)`` float32, on the
    container's device. Returns ``y: (n_rows + 1,)`` (spill slot
    last). Index ranges are the caller's contract (``csc_spmspv`` checks
    them).

    On the card the plan needs the frontier's column lengths on the host:
    this call copies ``col_len[active]`` there and waits for it (the served
    wrapper ``csc_spmspv`` has them on the host already). B6's launch
    counter is ``csc_spmspv.launches``, bumped here and in ``csc_spmspv``,
    where the kernel launches."""
    dev = data.device
    check_operand(data, "data", torch.float32, 2, dev)
    check_operand(rows, "rows", torch.int32, 2, dev)
    check_operand(col_len, "col_len", torch.int32, 1, dev)
    check_operand(active, "active", torch.int32, 1, dev)
    check_operand(xvals, "xvals", torch.float32, 1, dev)
    if rows.shape != data.shape or active.shape != xvals.shape:
        raise ValueError("CscEll arrays or frontier arrays disagree in shape")
    if col_len.shape[0] != data.shape[0]:
        raise ValueError(f"col_len has {col_len.shape[0]} entries for {data.shape[0]} columns")
    _check_width(int(data.shape[1]), schedule)
    if dev.type == "cpu":
        return csc_spmspv_plain(data, rows, active, xvals, n_rows, schedule)
    if dev.type != "cuda":
        raise RuntimeError(f"csc_spmspv has no kernel for device {dev}")
    plan = spmspv_launch_plan(col_len[active.long()].cpu().numpy(), sm_count(dev))
    frontier = torch.cat([active, xvals.view(torch.int32),
                          torch.from_numpy(plan["pieces"].reshape(-1)).to(dev)])
    y = _spmspv_launch(data, rows, col_len, frontier, plan, n_rows, schedule)
    csc_spmspv.launches += 1
    return y


def _check_width(W: int, schedule: KernelSchedule) -> None:
    if W % schedule.nnz_tile:
        raise InfeasibleConfig(
            f"CscEll width {W} not aligned to nnz_tile {schedule.nnz_tile}; re-prepare with "
            "this schedule"
        )


def _spmspv_launch(data, rows, col_len, frontier, plan: dict, n_rows: int,
                   schedule: KernelSchedule, reads=None) -> torch.Tensor:
    """Launch B6 under ``plan`` on the container's CUDA device and current
    stream and return ``y: (n_rows + 1,)``. ``frontier``: int32 ``[active (k)
    | the bits of xvals (k) | plan["pieces"] (2 * extra)]``, a tensor on the
    device, or a host numpy array that the launch copies (one copy, through
    the pinned buffer of ``_staging``) into a device buffer kept per
    (device, stream). ``reads``: ``None``, or an int32
    tensor of ``plan["warps"]`` entries in which each warp writes the slots
    it loaded. The launch counter is the wrappers': ``chip_smoke.py`` runs
    plan alternatives through here without moving it."""
    from repro_torch.kernels.build import bind, check_launch

    dev = data.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    if isinstance(frontier, np.ndarray):
        host = frontier.ctypes.data
        buf, pinned, copied = _staging(dev, stream, frontier.size)
    else:
        host, pinned, copied, buf = None, None, None, frontier.data_ptr()
    y = torch.empty(n_rows + 1, dtype=torch.float32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = bind("spmspv_csc", "spmspv_csc_launch", [vp] * 8 + [ci] * 9 + [vp] * 2)
    with torch.cuda.device(dev):
        err = fn(
            data.data_ptr(), rows.data_ptr(), col_len.data_ptr(), host, pinned, copied, buf,
            y.data_ptr(),
            plan["k"], plan["extra"], int(data.shape[1]), n_rows, plan["lanes"],
            plan["piece"], plan["warps_per_cta"], plan["ctas"],
            int(schedule.accum_dtype == "bfloat16"),
            None if reads is None else reads.data_ptr(), stream,
        )
    check_launch(err, "csc_spmspv")
    return y


_STAGING: dict[tuple[int, int], tuple] = {}


def _staging(dev: torch.device, stream: int, n: int) -> tuple[int, int, int]:
    """Pointers to the device buffer, the pinned host buffer (each at least
    ``n`` int32) and the event through which a launch on ``stream`` copies
    its frontier: one set per (device, stream), replaced by one of the next
    power of two when a frontier needs more. The launch waits on the event
    before it writes the pinned buffer and records it after its copy out of
    it; launches on one stream use the device buffer in stream order."""
    key = (dev.index, stream)
    st = _STAGING.get(key)
    if st is None or st[0] < n:
        if st is not None:
            st[-1][2].synchronize()  # the old pinned buffer's last copy has run
        cap = 1 << max(n - 1, 1023).bit_length()
        buf = torch.empty(cap, dtype=torch.int32, device=dev)
        pinned = torch.empty(cap, dtype=torch.int32, pin_memory=True)
        with torch.cuda.device(dev):
            copied = torch.cuda.Event()
            copied.record()  # creates the event on dev
        st = _STAGING[key] = (cap, buf.data_ptr(), pinned.data_ptr(), copied.cuda_event,
                              (buf, pinned, copied))
    return st[1], st[2], st[3]


def csc_spmspv(
    mat: CscEll,
    active,
    xvals,
    schedule: KernelSchedule = DEFAULT_SCHEDULE,
) -> torch.Tensor:
    """Frontier-level wrapper: validates, plans the launch from the host copy
    of the column lengths, launches (the frontier and the plan's pieces go
    to the container's device in one copy, made by the launch), truncates
    the spill slot.

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
    if dev.type != "cuda":  # the plain version on the CPU; anything else raises
        y = csc_spmspv_kernel(mat.data, mat.rows, mat.col_len, torch.from_numpy(active),
                              torch.from_numpy(xvals), n_rows, schedule)
        return y[:n_rows]
    _check_width(mat.width, schedule)
    plan = served_plan(mat, active, sm_count(dev))
    frontier = np.concatenate([active, xvals.view(np.int32), plan["pieces"].reshape(-1)])
    y = _spmspv_launch(mat.data, mat.rows, mat.col_len, frontier, plan, n_rows, schedule)
    csc_spmspv.launches += 1
    return y[:n_rows]


csc_spmspv.launches = 0  # B6 kernel launches made by this process
