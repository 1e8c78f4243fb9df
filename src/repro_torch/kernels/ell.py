"""ELL SpMV and SpMM: CUDA kernel wrappers + their plain PyTorch versions.

``ell_spmv`` computes ``y[r] = sum_k data[r, k] * x[cols[r, k]]`` over
row-major ``(R, W)`` planes whose padding slots hold value 0 / column 0. On
a CUDA tensor it launches ``csrc/spmv_ell.cu`` (a CTA owns
``rows_per_block`` rows, a warp per row, lanes stride the width with
``unroll`` accumulators each) or raises; on a CPU tensor — and only then —
it takes ``ell_spmv_plain``. Shapes must be tile-aligned as for the
reference kernel: ``R % rows_per_block == 0`` and ``W % nnz_tile == 0``.

``ell_spmm`` is the multi-vector form over the same planes,
``Y[r, j] = sum_k data[r, k] * X[cols[r, k], j]`` with a row-major dense
``X: (n_cols, k)``; it launches ``csrc/spmm_ell.cu`` (a warp per row, its
lanes split between the output columns and the row's slots) on a CUDA
tensor and takes ``ell_spmm_plain`` on a CPU one. ``schedule.unroll`` is
not read by either, as in the reference's SpMM kernel.
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


def _check_planes(data, cols, operand, name: str, ndim: int, schedule: KernelSchedule):
    """The checks both ELL wrappers make: float32 ``data`` and operand,
    int32 ``cols`` on the operand's device, planes of one tile-aligned
    shape. Returns the planes' ``(R, W)``."""
    dev = operand.device
    check_operand(operand, name, torch.float32, ndim, dev)
    check_operand(data, "data", torch.float32, 2, dev)
    check_operand(cols, "cols", torch.int32, 2, dev)
    if cols.shape != data.shape:
        raise ValueError("ELL planes disagree in shape")
    R, W = data.shape
    rpb, nt = schedule.rows_per_block, schedule.nnz_tile
    if R % rpb or W % nt:
        raise ValueError(f"ELL planes ({R},{W}) not aligned to ({rpb},{nt})")
    return R, W


def _launch(wrapper, source: str, data, cols, operand, out_shape, ints) -> torch.Tensor:
    """Launch ``source``'s kernel on the operand's CUDA device and current
    stream with ``(data, cols, operand, out, *ints, stream)``, count the
    launch on ``wrapper`` and return ``out``; raises on any other device."""
    dev = operand.device
    if dev.type != "cuda":
        raise RuntimeError(f"{wrapper.__name__} has no kernel for device {dev}")
    from repro_torch.kernels.build import bind, check_launch

    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = bind(source, f"{source}_launch", [vp] * 4 + [ci] * len(ints) + [vp])
    with torch.cuda.device(dev):
        err = fn(data.data_ptr(), cols.data_ptr(), operand.data_ptr(), out.data_ptr(), *ints,
                 torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, wrapper.__name__)
    wrapper.launches += 1
    return out


def ell_spmv(
    data: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, schedule: KernelSchedule
) -> torch.Tensor:
    """SpMV over padded ELL planes ``data/cols: (R, W)``; returns ``y: (R,)``."""
    R, W = _check_planes(data, cols, x, "x", 1, schedule)
    if x.device.type == "cpu":
        return ell_spmv_plain(data, cols, x, schedule)
    bf16 = int(schedule.accum_dtype == "bfloat16")
    return _launch(ell_spmv, "spmv_ell", data, cols, x, (R,),
                   (R, W, schedule.rows_per_block, schedule.unroll, bf16))


ell_spmv.launches = 0  # kernel launches made by this process


def ell_spmm_plain(
    data: torch.Tensor, cols: torch.Tensor, X: torch.Tensor, schedule: KernelSchedule
) -> torch.Tensor:
    """Gather the rows of X per slot, multiply, sum along the width. bf16:
    operands and products rounded to bf16, the row sums taken in float32
    and rounded once."""
    xg = X[cols.long()]  # (R, W, k)
    if schedule.accum_dtype == "bfloat16":
        prods = bf16_round(bf16_round(data)[:, :, None] * bf16_round(xg))
        return bf16_round(prods.sum(dim=1))
    return torch.einsum("rw,rwk->rk", data, xg)


def ell_spmm(
    data: torch.Tensor, cols: torch.Tensor, X: torch.Tensor, schedule: KernelSchedule
) -> torch.Tensor:
    """SpMM over padded ELL planes ``data/cols: (R, W)`` and a dense
    row-major ``X: (n_cols, k)``; returns ``Y: (R, k)`` (float32)."""
    R, W = _check_planes(data, cols, X, "X", 2, schedule)
    if X.device.type == "cpu":
        return ell_spmm_plain(data, cols, X, schedule)
    k = X.shape[1]
    bf16 = int(schedule.accum_dtype == "bfloat16")
    return _launch(ell_spmm, "spmm_ell", data, cols, X, (R, k),
                   (R, W, k, schedule.rows_per_block, bf16))


ell_spmm.launches = 0  # kernel launches made by this process
