"""CSR SpMV: CUDA kernel wrapper + its plain PyTorch version.

``csr_spmv`` computes ``y[row] = sum_k data[k] * x[indices[k]]`` over
``k in [indptr[row], indptr[row+1])``. On a CUDA tensor it launches the
kernel of ``csrc/spmv_csr.cu`` or raises; on a CPU tensor — and only then —
it takes ``csr_spmv_plain``.

One launch, two kinds of CTA, so that a hub row no longer sets the pace:

* row CTAs own ``rows_per_block`` consecutive rows, one warp per row at a
  time (lanes stride the row, ``unroll`` accumulators each, a shuffle tree);
  they skip a row of more than ``hub_row`` nonzeros;
* chunk CTAs, first in launch order, own ``chunk`` consecutive nonzeros
  each and add the part of every hub row that falls in them, all threads of
  the CTA at once; the pieces of a hub row that crosses chunks are added in
  chunk order by the CTA that finishes last (a ticket per row in scratch
  the wrapper keeps per (device, stream); every launch leaves it zeroed).

``csr_launch_plan`` builds the launch from integers; ``csr_chunk_rows`` and
``csr_hub_pieces`` are the host twins of where the chunks fall and what the
hub rows cost. The schedule's knobs map to it as:

=======================  ===============================================
``KernelSchedule``       launch
=======================  ===============================================
``rows_per_block``       rows per row CTA; its warps: min(rows_per_block,
                         8); the chunk CTAs have as many threads
``unroll``               accumulators per lane of a row warp
``accum_dtype``          float32, or bf16 products: a row warp's lanes sum
                         them in bf16, folded into a float32 carry every
                         ``CSR_CARRY_PRODUCTS`` of a row's products; chunk
                         CTAs add them in float32; y is rounded once
``x_residency``          the SM's L1 / shared-memory split (x is read
                         through L1): ``"vmem"`` the least shared memory
                         that keeps the CTAs an SM holds, ``"stream"`` the
                         most shared memory
``nnz_tile``,            not read: CSR pads nothing
``dimension_semantics``
=======================  ===============================================

``hub_row`` (``CSR_HUB_ROW``, or ``CSR_NO_HUB`` where ``x`` has no more
entries than that) and ``chunk`` (from ``nnz``, ``n_rows``, the threads and
the card's SM count) are set by the plan, not by the schedule.
No atomics touch ``y``, so two launches give the same bits. Precondition of
the kernel (every ``CSR`` container holds it): ``indptr[0] == 0`` and
``indptr[-1] == len(data)``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import KernelSchedule, bf16_round, check_operand, sm_count
from repro_torch.obs.trace import NOOP_SPAN, get_tracer

_TRACER = get_tracer()

# shared with csrc/spmv_csr.cu's spmv_csr_constants: threads per CTA and
# hub rows per chunk at most; the nonzeros a chunk CTA's thread loads per
# round of a hub part, added as a pairwise tree
CSR_MAX_THREADS = 256
CSR_MAX_HUBS = 128
CSR_ROUND = 8
# bf16: a row's products between two folds of a lane's sums into its float32
# carry (the kernel's kCarryProducts)
CSR_CARRY_PRODUCTS = 128
CSR_HUB_ROW = 1024  # a longer row goes to the chunk CTAs: 4 trips of a warp at unroll 8
# hub_row when no row can be longer than CSR_HUB_ROW (a row holds at most
# n_cols nonzeros): the kernel then launches no chunk CTA
CSR_NO_HUB = 2**31 - 1
# nonzeros of a chunk per thread of its CTA, a power of two: about nnz /
# (2 x SMs) in all within the last two bounds, then halved down to the first
# while a chunk spans more than CSR_CHUNK_ROWS rows on average (a chunk CTA
# checks every row of its chunk and adds its hub rows one after another)
CSR_CHUNK_PER_THREAD = (8, 64, 256)
CSR_CHUNK_ROWS = 512


def csr_spmv_plain(
    data: torch.Tensor,
    indices: torch.Tensor,
    indptr: torch.Tensor,
    x: torch.Tensor,
    schedule: KernelSchedule,
) -> torch.Tensor:
    """Gather, multiply, ``index_add_``. With ``accum_dtype="bfloat16"`` the
    operands and products are rounded to bf16; torch offers no ordered bf16
    running sum, so the segmented sum is taken in float32 and rounded once."""
    n_rows = indptr.shape[0] - 1
    counts = (indptr[1:] - indptr[:-1]).long()
    row_ids = torch.repeat_interleave(
        torch.arange(n_rows, device=x.device), counts, output_size=data.shape[0]
    )
    xg = x[indices.long()]
    bf16 = schedule.accum_dtype == "bfloat16"
    prods = bf16_round(bf16_round(data) * bf16_round(xg)) if bf16 else data * xg
    y = torch.zeros(n_rows, dtype=torch.float32, device=x.device)
    y.index_add_(0, row_ids, prods)
    return (bf16_round(y) if bf16 else y).to(x.dtype)


def csr_launch_plan(n_rows: int, nnz: int, rows_per_block: int, unroll: int, n_sms: int,
                    hub_row: int = CSR_HUB_ROW, chunk: int | None = None, *,
                    n_cols: int | None = None) -> dict:
    """B1's launch for ``n_rows`` rows and ``nnz`` nonzeros at a schedule's
    ``rows_per_block`` and ``unroll`` on a card of ``n_sms`` SMs, from
    integers only (a launch copies nothing from the device): threads per
    CTA, the chunk CTAs (first in launch order, ``chunk`` nonzeros each:
    unless given, by the rule of ``CSR_CHUNK_PER_THREAD``, while a chunk can
    hold no more hub rows than ``CSR_MAX_HUBS``) and the row CTAs. With
    ``n_cols`` no larger than ``hub_row`` no row can be a hub (CSR stores a
    column once per row): ``hub_row`` becomes ``CSR_NO_HUB`` and no chunk CTA
    is launched, so the row CTAs take every row."""
    n_rows, nnz, rpb, unroll = int(n_rows), int(nnz), int(rows_per_block), int(unroll)
    hub_row = int(hub_row)
    if n_rows < 0 or nnz < 0 or rpb < 1 or unroll not in (1, 2, 4, 8) or hub_row < 1:
        raise ValueError(f"no CSR launch for rows_per_block={rpb}, unroll={unroll}, "
                         f"hub_row={hub_row}")
    threads = 32 * min(rpb, CSR_MAX_THREADS // 32)
    if chunk is None:  # and no more hub rows than a chunk CTA can list
        floor, lo, hi = CSR_CHUNK_PER_THREAD
        per_thread = lo
        while (per_thread < hi and per_thread * threads * 2 * int(n_sms) < nnz
               and 2 * per_thread * threads // hub_row + 2 <= CSR_MAX_HUBS):
            per_thread *= 2
        while per_thread > floor and per_thread * threads * n_rows > CSR_CHUNK_ROWS * nnz:
            per_thread //= 2
        chunk = per_thread * threads
    chunk = int(chunk)
    if chunk < 1 or chunk // hub_row + 2 > CSR_MAX_HUBS:
        raise ValueError(f"no CSR launch for chunk={chunk} at hub_row={hub_row}")
    if n_cols is not None and int(n_cols) <= hub_row:
        hub_row = CSR_NO_HUB
    hub_ctas = 0 if hub_row == CSR_NO_HUB else -(-nnz // chunk)
    row_ctas = -(-n_rows // rpb)
    return {"threads": threads, "rows_per_cta": rpb, "unroll": unroll, "hub_row": hub_row,
            "chunk": chunk, "hub_ctas": hub_ctas, "row_ctas": row_ctas,
            "ctas": hub_ctas + row_ctas}


def csr_chunk_rows(indptr: torch.Tensor, plan: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Host twin of the chunk CTAs' search: for chunk ``h`` the rows that
    hold its first nonzero ``h * chunk`` and its last one."""
    ptr = indptr.detach().to("cpu", torch.int64)
    nnz, chunk = int(ptr[-1]), plan["chunk"]
    first = torch.arange(plan["hub_ctas"], dtype=torch.int64) * chunk
    last = torch.clamp(first + chunk, max=nnz) - 1
    ends = ptr[1:]
    return (torch.searchsorted(ends, first, right=True),
            torch.searchsorted(ends, last, right=True))


def csr_hub_pieces(indptr: torch.Tensor, plan: dict) -> dict:
    """What the hub rows (more than ``hub_row`` nonzeros) cost: how many,
    their nonzeros, the longest row, and the pieces stored for the rows that
    cross chunks (row ``r`` lies in chunks ``indptr[r] // chunk ..
    (indptr[r + 1] - 1) // chunk``, one piece each)."""
    ptr = indptr.detach().to("cpu", torch.int64)
    lengths = ptr[1:] - ptr[:-1]
    r = torch.nonzero(lengths > plan["hub_row"]).flatten()
    first, last = ptr[r] // plan["chunk"], (ptr[r + 1] - 1) // plan["chunk"]
    cross = last > first
    return {"hub_rows": int(r.numel()), "hub_nnz": int(lengths[r].sum()),
            "longest": int(lengths.max()) if lengths.numel() else 0,
            "crossing_rows": int(cross.sum()), "pieces": int((last - first + 1)[cross].sum())}


# scratch per (device, stream): ticket counters (zero between launches: the
# kernel resets each one it uses) and the pieces of split rows
_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def _scratch(dev: torch.device, stream: int, ctas: int) -> tuple[int, int, int]:
    """Pointers to ``ctas`` tickets, end pieces and start pieces (one per
    chunk CTA): one zeroed int32 buffer of three equal parts, kept per
    (device, stream) and replaced by a larger one when a launch needs more."""
    key = (dev.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.shape[0] < 3 * ctas:
        buf = _SCRATCH[key] = torch.zeros(3 * max(ctas, 1024), dtype=torch.int32, device=dev)
    cap = buf.shape[0] // 3
    base = buf.data_ptr()
    return base, base + 4 * cap, base + 8 * cap


def _csr_launch(
    data: torch.Tensor,
    indices: torch.Tensor,
    indptr: torch.Tensor,
    x: torch.Tensor,
    plan: dict,
    schedule: KernelSchedule,
) -> torch.Tensor:
    """Launch B1 at ``plan`` on checked CUDA operands; ``y``. The launch
    counter is the wrapper's, not this helper's: ``chip_smoke.py`` runs the
    plan's alternatives through here without moving it."""
    from repro_torch.kernels.build import bind, check_launch

    dev = x.device
    n_rows = indptr.shape[0] - 1
    y = torch.empty(n_rows, dtype=torch.float32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = bind("spmv_csr", "spmv_csr_launch", [vp] * 5 + [ci] * 8 + [vp] * 3 + [ci, ci, vp])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets, end_part, start_part = _scratch(dev, stream, plan["hub_ctas"])
        err = fn(
            data.data_ptr(), indices.data_ptr(), indptr.data_ptr(), x.data_ptr(),
            y.data_ptr(), n_rows, data.shape[0], plan["rows_per_cta"], plan["unroll"],
            plan["hub_row"], plan["chunk"], plan["hub_ctas"], plan["ctas"], tickets,
            end_part, start_part, int(schedule.accum_dtype == "bfloat16"),
            int(schedule.x_residency == "stream"), stream,
        )
    check_launch(err, "csr_spmv")
    return y


def csr_spmv(
    data: torch.Tensor,
    indices: torch.Tensor,
    indptr: torch.Tensor,
    x: torch.Tensor,
    schedule: KernelSchedule,
) -> torch.Tensor:
    """SpMV over CSR arrays. ``data (nnz,) f32``, ``indices (nnz,) i32``,
    ``indptr (n_rows+1,) i32``, ``x (n_cols,) f32`` -> ``y (n_rows,) f32``."""
    dev = x.device
    check_operand(x, "x", torch.float32, 1, dev)
    check_operand(data, "data", torch.float32, 1, dev)
    check_operand(indices, "indices", torch.int32, 1, dev)
    check_operand(indptr, "indptr", torch.int32, 1, dev)
    if indices.shape != data.shape or indptr.shape[0] < 1:
        raise ValueError("CSR arrays disagree in length")
    if dev.type == "cpu":
        return csr_spmv_plain(data, indices, indptr, x, schedule)
    if dev.type != "cuda":
        raise RuntimeError(f"csr_spmv has no kernel for device {dev}")
    plan = csr_launch_plan(indptr.shape[0] - 1, data.shape[0], schedule.rows_per_block,
                           schedule.unroll, sm_count(dev), n_cols=x.shape[0])
    with _TRACER.span("kernel.launch", kernel="csr_spmv") if _TRACER.enabled else NOOP_SPAN:
        y = _csr_launch(data, indices, indptr, x, plan, schedule)
    csr_spmv.launches += 1
    return y


csr_spmv.launches = 0  # kernel launches made by this process
