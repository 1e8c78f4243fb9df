"""SELL-C-q SpMV: CUDA kernel wrapper + its plain PyTorch version.

Storage is the flat ragged column-major layout of ``sparse/formats.SELL``:
element (row r, k-th stored nonzero) of slice s lives at
``slice_ptr[s] + k*C + r``. ``sell_spmv`` returns ``y: (n_slices, C)``. On a
CUDA tensor it launches ``csrc/spmv_sell.cu`` or raises; on a CPU tensor —
and only then — it takes ``sell_spmv_plain``. The launch comes from
``sell_launch_plan`` (shapes and the card's SM count only): P threads per
row stride the row's stored nonzeros, each with ``unroll`` accumulators,
several slices share a CTA where ``P * C`` is small, and the P partials
of a row are added in a fixed order. With ``accum_dtype="bfloat16"`` each
thread folds its bf16 sums into a float32 carry after every
``SELL_CARRY_PRODUCTS`` of its row's products (the reference sums a tile of
128 in bf16 and collects tiles in float32), so no bf16 running sum spans a
long row. The reference kernel's tile pointers,
width-in-tiles array and masked out-of-range tiles have no counterpart:
the loop bound is a runtime value.

Precondition of the kernel (not of the plain version): each row stores
its nonzeros first and its padding (value 0, column 0) after, as
``sell_from_dense`` writes them. A warp stops after the first step at
which every one of its threads reads padding (``sell_live_width`` is the
rule's host twin) and gathers no x for a padding slot, so it differs from
summing every slot only where ``x[0]`` is not finite.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import KernelSchedule, bf16_round, check_operand, sm_count
from repro_torch.obs.trace import NOOP_SPAN, get_tracer

_TRACER = get_tracer()

SELL_ROW_THREADS = (1, 2, 4, 8, 16, 32)  # P, threads per row
SELL_MAX_THREADS = 1024  # per CTA: csrc/spmv_sell.cu's spmv_sell_constants
# the most threads per row until the grid holds this many warps per SM
SELL_TARGET_WARPS_PER_SM = 32
# slices share a CTA until it holds at least this many threads
SELL_MIN_CTA_THREADS = 128
# bf16: a row's products between two folds of a thread's sums into its
# float32 carry (csrc/spmv_sell.cu's kCarryProducts)
SELL_CARRY_PRODUCTS = 128


def sell_spmv_plain(
    data: torch.Tensor,
    cols: torch.Tensor,
    slice_ptr: torch.Tensor,
    slice_width: torch.Tensor,
    x: torch.Tensor,
    C: int,
    schedule: KernelSchedule,
) -> torch.Tensor:
    """Gather, multiply, ``index_add_`` by (slice, row-in-slice). bf16:
    operands and products rounded to bf16, the sum taken in float32 and
    rounded once."""
    n_slices = slice_width.shape[0]
    total = data.shape[0]
    # slot id of every stored element: slice * C + (offset within slice) % C
    sizes = slice_width.long() * C
    slice_of = torch.repeat_interleave(
        torch.arange(n_slices, device=x.device), sizes, output_size=total
    )
    offset = torch.arange(total, device=x.device) - slice_ptr.long()[slice_of]
    slot = slice_of * C + offset % C
    xg = x[cols.long()]
    bf16 = schedule.accum_dtype == "bfloat16"
    prods = bf16_round(bf16_round(data) * bf16_round(xg)) if bf16 else data * xg
    y = torch.zeros(n_slices * C, dtype=torch.float32, device=x.device)
    y.index_add_(0, slot, prods)
    return (bf16_round(y) if bf16 else y).to(x.dtype).reshape(n_slices, C)


def sell_launch_plan(n_slices: int, C: int, mean_width: float, n_sms: int) -> dict:
    """B3's launch from integers only: ``n_slices`` slices of height ``C``,
    their mean stored width (``len(data) / (n_slices * C)``, from shapes, so
    a launch copies nothing from the device) and the card's SM count.

    * ``row_threads`` (P): the most of ``SELL_ROW_THREADS`` while
      ``n_slices * C * P`` threads stay within ``SELL_TARGET_WARPS_PER_SM``
      warps per SM, ``P * C`` within a CTA and P within the mean width.
      Thread ``p * C + r`` of a slice takes its row r's elements ``k = p,
      p + P, ...``: at each step the slice's P * C threads read P * C
      consecutive elements.
    * ``slices_per_cta``: slices share a CTA until it holds
      ``SELL_MIN_CTA_THREADS`` threads; the CTA is rounded up to whole warps
      (``threads``), the threads past its slices idle.
    """
    n_slices, C, n_sms = int(n_slices), int(C), int(n_sms)
    if not 1 <= C <= SELL_MAX_THREADS or n_slices < 0 or n_sms < 1:
        raise ValueError(f"no SELL launch for n_slices={n_slices}, C={C}, n_sms={n_sms}")
    target = SELL_TARGET_WARPS_PER_SM * 32 * n_sms
    P = SELL_ROW_THREADS[0]
    for nxt in SELL_ROW_THREADS[1:]:
        if (n_slices * C * nxt > target or nxt * C > SELL_MAX_THREADS
                or nxt > max(float(mean_width), 1.0)):
            break
        P = nxt
    return sell_grid(n_slices, C, P)


def sell_grid(n_slices: int, C: int, P: int) -> dict:
    """The plan's dict for P threads per row: slices per CTA, threads per
    CTA (whole warps) and CTAs."""
    per_slice = P * C
    spc = max(1, min(SELL_MIN_CTA_THREADS // per_slice, SELL_MAX_THREADS // per_slice))
    threads = -(-spc * per_slice // 32) * 32
    return {"row_threads": P, "slices_per_cta": spc, "threads": threads,
            "ctas": -(-n_slices // spc)}


def sell_plan_choices(n_slices: int, C: int, mean_width: float, n_sms: int) -> list[dict]:
    """The plan first, then every other P that fits a CTA."""
    plan = sell_launch_plan(n_slices, C, mean_width, n_sms)
    return [plan] + [sell_grid(n_slices, C, P) for P in SELL_ROW_THREADS
                     if P * C <= SELL_MAX_THREADS and P != plan["row_threads"]]


def sell_live_width(
    data: torch.Tensor, slice_ptr: torch.Tensor, slice_width: torch.Tensor, C: int
) -> torch.Tensor:
    """Live elements of each stored row, ``(n_slices * C,)`` int64: the
    index k of its first zero value, else its slice's width. Rows store
    their nonzeros first, so this is the row's length; B3's stop rule reads
    it."""
    n_slices = slice_width.shape[0]
    sizes = slice_width.long() * C
    slice_of = torch.repeat_interleave(
        torch.arange(n_slices, device=data.device), sizes, output_size=data.shape[0])
    offset = torch.arange(data.shape[0], device=data.device) - slice_ptr.long()[slice_of]
    slot = slice_of * C + offset % C
    k = torch.div(offset, C, rounding_mode="floor")
    live = slice_width.long().repeat_interleave(C)  # the width where no zero is stored
    pad = data == 0
    return live.scatter_reduce(0, slot[pad], k[pad], reduce="amin")


def sell_slots_read(live: torch.Tensor, slice_width: torch.Tensor, C: int, plan: dict,
                    unroll: int) -> int:
    """Elements B3 reads under ``plan`` for rows of ``live`` live elements:
    the kernel's stop rule per warp. Step ``j`` of thread ``(p, r)`` reads
    ``k = j*P*U + u*P + p`` (u < U); a warp stops after the first step at
    which, for every thread, ``k`` at ``u = U - 1`` is padding (at or past
    the row's live width), or when the step passes its slices' widest."""
    n_slices = slice_width.shape[0]
    P, spc, threads = plan["row_threads"], plan["slices_per_cta"], plan["threads"]
    per_slice = P * C
    t = torch.arange(plan["ctas"] * threads)
    cta, local = t // threads, t % threads
    s = cta * spc + local // per_slice
    ok = (local < spc * per_slice) & (s < n_slices)
    p, r = (local % per_slice) // C, local % C
    s = torch.where(ok, s, 0)
    width = torch.where(ok, slice_width.long()[s], 0)
    row_live = torch.where(ok, live[s * C + r], 0)
    step = P * unroll
    # steps the thread itself needs before its last element of a step is padding
    own = torch.div(row_live - (unroll - 1) * P - p + step - 1, step, rounding_mode="floor")
    own = torch.clamp(own, min=0) + 1
    warp = t // 32
    need = torch.zeros(int(warp.max()) + 1 if t.numel() else 0, dtype=torch.int64)
    need.scatter_reduce_(0, warp, own, reduce="amax")
    wmax = torch.zeros_like(need).scatter_reduce_(0, warp, width, reduce="amax")
    steps = torch.minimum(need, torch.div(wmax + step - 1, step, rounding_mode="floor"))
    steps_t = steps[warp]
    # elements k = j*step + u*P + p < width over the steps the warp runs
    u = torch.arange(unroll)
    j = torch.arange(int(steps.max()) if steps.numel() else 0)
    kk = j[:, None, None] * step + u[None, :, None] * P + p[None, None, :]
    read = (kk < width[None, None, :]) & (j[:, None, None] < steps_t[None, None, :])
    return int(read.sum())


def sell_spmv(
    data: torch.Tensor,
    cols: torch.Tensor,
    slice_ptr: torch.Tensor,
    slice_width: torch.Tensor,
    x: torch.Tensor,
    C: int,
    schedule: KernelSchedule,
) -> torch.Tensor:
    """SpMV over flat SELL storage. ``data/cols: (total,)``, ``slice_ptr:
    (S+1,) i32``, ``slice_width: (S,) i32`` -> ``y: (S, C)``.

    The kernel's precondition (the module's note): each row's nonzeros come
    before its padding, so a row holds no stored zero before a nonzero.
    ``sell_from_dense`` writes slices so; the wrapper does not check storage
    from elsewhere, on which the kernel may drop what follows a stored zero."""
    dev = x.device
    check_operand(x, "x", torch.float32, 1, dev)
    check_operand(data, "data", torch.float32, 1, dev)
    check_operand(cols, "cols", torch.int32, 1, dev)
    check_operand(slice_ptr, "slice_ptr", torch.int32, 1, dev)
    check_operand(slice_width, "slice_width", torch.int32, 1, dev)
    n_slices = slice_width.shape[0]
    if cols.shape != data.shape or slice_ptr.shape[0] != n_slices + 1:
        raise ValueError("SELL arrays disagree in length")
    if not 1 <= C <= 1024:
        raise ValueError(f"slice height C={C} outside 1..1024 (one thread per row)")
    if dev.type == "cpu":
        return sell_spmv_plain(data, cols, slice_ptr, slice_width, x, C, schedule)
    if dev.type != "cuda":
        raise RuntimeError(f"sell_spmv has no kernel for device {dev}")
    plan = sell_launch_plan(n_slices, C, data.shape[0] / max(n_slices * C, 1), sm_count(dev))
    with _TRACER.span("kernel.launch", kernel="sell_spmv") if _TRACER.enabled else NOOP_SPAN:
        y = _sell_launch(data, cols, slice_ptr, slice_width, x, C, plan, schedule)
    sell_spmv.launches += 1
    return y


def _sell_launch(data, cols, slice_ptr, slice_width, x, C: int, plan: dict,
                 schedule: KernelSchedule, reads=None) -> torch.Tensor:
    """Launch B3 under ``plan`` on x's CUDA device and current stream and
    return ``y: (S, C)``. ``reads``: ``None``, or an int32 tensor of
    ``plan["ctas"] * plan["threads"]`` entries in which each thread writes
    the elements it loaded."""
    from repro_torch.kernels.build import bind, check_launch

    dev = x.device
    n_slices = slice_width.shape[0]
    y = torch.empty((n_slices, C), dtype=torch.float32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = bind("spmv_sell", "spmv_sell_launch", [vp] * 6 + [ci] * 8 + [vp] * 2)
    with torch.cuda.device(dev):
        err = fn(
            data.data_ptr(), cols.data_ptr(), slice_ptr.data_ptr(),
            slice_width.data_ptr(), x.data_ptr(), y.data_ptr(), n_slices, C,
            schedule.unroll, int(schedule.accum_dtype == "bfloat16"),
            plan["row_threads"], plan["slices_per_cta"], plan["threads"], plan["ctas"],
            None if reads is None else reads.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(err, "sell_spmv")
    return y


sell_spmv.launches = 0  # kernel launches made by this process
