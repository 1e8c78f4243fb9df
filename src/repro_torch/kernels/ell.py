"""ELL SpMV: CUDA kernel wrapper + its plain PyTorch version.

``ell_spmv`` computes ``y[r] = sum_k data[r, k] * x[cols[r, k]]`` over
row-major ``(R, W)`` planes whose padding slots hold value 0 / column 0. On
a CUDA tensor it launches ``csrc/spmv_ell.cu`` (a CTA owns
``rows_per_block`` rows, a warp per row, lanes stride the width with
``unroll`` accumulators each) or raises; on a CPU tensor — and only then —
it takes ``ell_spmv_plain``. Shapes must be tile-aligned as for the
reference kernel: ``R % rows_per_block == 0`` and ``W % nnz_tile == 0``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import KernelSchedule, bf16_round, check_operand


def ell_spmv_plain(
    data: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, schedule: KernelSchedule
) -> torch.Tensor:
    """Gather, multiply, sum along the width. bf16: operands and products
    rounded to bf16, the row sum taken in float32 and rounded once."""
    xg = x[cols.long()]
    if schedule.accum_dtype == "bfloat16":
        prods = bf16_round(bf16_round(data) * bf16_round(xg))
        return bf16_round(prods.sum(dim=1)).to(x.dtype)
    return (data * xg).sum(dim=1)


def ell_spmv(
    data: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, schedule: KernelSchedule
) -> torch.Tensor:
    """SpMV over padded ELL planes ``data/cols: (R, W)``; returns ``y: (R,)``."""
    dev = x.device
    check_operand(x, "x", torch.float32, 1, dev)
    check_operand(data, "data", torch.float32, 2, dev)
    check_operand(cols, "cols", torch.int32, 2, dev)
    if cols.shape != data.shape:
        raise ValueError("ELL planes disagree in shape")
    R, W = data.shape
    rpb, nt = schedule.rows_per_block, schedule.nnz_tile
    if R % rpb or W % nt:
        raise ValueError(f"ELL planes ({R},{W}) not aligned to ({rpb},{nt})")
    if dev.type == "cpu":
        return ell_spmv_plain(data, cols, x, schedule)
    if dev.type != "cuda":
        raise RuntimeError(f"ell_spmv has no kernel for device {dev}")
    from repro_torch.kernels.build import bind, check_launch

    y = torch.empty(R, dtype=torch.float32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = bind("spmv_ell", "spmv_ell_launch", [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp])
    with torch.cuda.device(dev):
        err = fn(
            data.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
            R, W, rpb, schedule.unroll, int(schedule.accum_dtype == "bfloat16"),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(err, "ell_spmv")
    ell_spmv.launches += 1
    return y


ell_spmv.launches = 0  # kernel launches made by this process
