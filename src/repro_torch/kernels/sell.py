"""SELL-C-q SpMV: CUDA kernel wrapper + its plain PyTorch version.

Storage is the flat ragged column-major layout of ``sparse/formats.SELL``:
element (row r, k-th stored nonzero) of slice s lives at
``slice_ptr[s] + k*C + r``. ``sell_spmv`` returns ``y: (n_slices, C)``. On a
CUDA tensor it launches ``csrc/spmv_sell.cu`` (one CTA of C threads per
slice, thread r loops ``k < slice_width[s]``, ``unroll`` accumulators) or
raises; on a CPU tensor — and only then — it takes ``sell_spmv_plain``.
The reference kernel's tile pointers, width-in-tiles array and masked
out-of-range tiles have no counterpart: the loop bound is a runtime value.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import KernelSchedule, bf16_round, check_operand


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
    (S+1,) i32``, ``slice_width: (S,) i32`` -> ``y: (S, C)``."""
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
    from repro_torch.kernels.build import bind, check_launch

    y = torch.empty((n_slices, C), dtype=torch.float32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = bind("spmv_sell", "spmv_sell_launch", [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp])
    with torch.cuda.device(dev):
        err = fn(
            data.data_ptr(), cols.data_ptr(), slice_ptr.data_ptr(),
            slice_width.data_ptr(), x.data_ptr(), y.data_ptr(), n_slices, C,
            schedule.unroll, int(schedule.accum_dtype == "bfloat16"),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(err, "sell_spmv")
    sell_spmv.launches += 1
    return y


sell_spmv.launches = 0  # kernel launches made by this process
