"""CSR SpMV: CUDA kernel wrapper + its plain PyTorch version.

``csr_spmv`` computes ``y[row] = sum_k data[k] * x[indices[k]]`` over
``k in [indptr[row], indptr[row+1])``. On a CUDA tensor it launches the
vector-CSR kernel of ``csrc/spmv_csr.cu`` (a CTA owns ``rows_per_block``
rows, one warp per row, ``unroll`` accumulators per lane, shuffle reduce;
no atomics, no padding, no ``row_ids``) or raises; on a CPU tensor — and
only then — it takes ``csr_spmv_plain``. ``nnz_tile`` has nothing to align
in CSR storage and is not read; a loop trip consumes ``32 * unroll``
elements per warp.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import KernelSchedule, bf16_round, check_operand


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
    from repro_torch.kernels.build import bind, check_launch

    n_rows = indptr.shape[0] - 1
    y = torch.empty(n_rows, dtype=torch.float32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = bind("spmv_csr", "spmv_csr_launch", [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp])
    with torch.cuda.device(dev):
        err = fn(
            data.data_ptr(), indices.data_ptr(), indptr.data_ptr(), x.data_ptr(),
            y.data_ptr(), n_rows, schedule.rows_per_block, schedule.unroll,
            int(schedule.accum_dtype == "bfloat16"),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(err, "csr_spmv")
    csr_spmv.launches += 1
    return y


csr_spmv.launches = 0  # kernel launches made by this process
